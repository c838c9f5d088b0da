"""Rank a dry-run cell's collectives by link bytes times how often they
run, with the model code behind each one: the port's dry-run profiler.

The counterpart of ``tools/collective_profile.py``.  Where that tool reads
the compiled HLO module on 512 placeholder CPU devices and names each
collective by its JAX ``op_name``, this one traces the cell's step on a
fake process group of 256 (or 512) ranks as ``repro_torch.launch.dryrun``
does, reads rank 0's ``make_fx`` graph, and names each ``_c10d_functional``
node by the innermost frames of ``repro_torch`` it was recorded under.  A
node's count is the scale the dry-run gives it (microbatches, time loops).
It runs on the CPU and needs no card.

Usage:
    PYTHONPATH=src python tools/collective_profile_torch.py granite-moe-1b-a400m train_4k
    PYTHONPATH=src python tools/collective_profile_torch.py granite-8b decode_32k --top 5
    PYTHONPATH=src python tools/collective_profile_torch.py ARCH SHAPE [--tuned] [--multi-pod]
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

#: an origin is cut to its last 110 characters, as the reference cuts op_name
ORIGIN_CHARS = 110


def origin(node, frames: int = 3) -> str:
    """Where the model code asked for ``node``: the innermost ``frames``
    frames of ``repro_torch`` it was recorded under
    (``launch.dryrun.record(origins=True)``), outermost first, else ``"?"``;
    the last :data:`ORIGIN_CHARS` characters."""
    ours = node.meta.get("origin") or ["?"]
    return " > ".join(ours[-frames:])[-ORIGIN_CHARS:]


def entries(gm, weights: dict, gpus_per_node: int = 8) -> list[dict]:
    """One entry a collective node of ``gm``, its link bytes times its run
    count first."""
    from repro_torch.launch.hlo import collective_call

    out = []
    for node in gm.graph.nodes:
        call = collective_call(node, gpus_per_node)
        if call is None:
            continue
        op, p, _, link, spans = call
        count = weights.get(node, 1)
        val = node.meta["val"]
        out.append({"link_bytes": link * count, "op": op, "group": p, "count": count,
                    "shape": f"{str(val.dtype).removeprefix('torch.')}{list(val.shape)}",
                    "spans_nodes": spans, "origin": origin(node)})
    out.sort(key=lambda e: -e["link_bytes"])
    return out


def rank_cell(cfg, shape, mesh, rules, accum: int | None = None):
    """``(entries, stats)`` of the step of ``cfg`` x ``shape`` on ``mesh``
    (a fake group's): the collectives ranked (:func:`entries`) and the
    step's :class:`~repro_torch.launch.hlo.ProgramStats`, whose link bytes
    they sum to."""
    from repro_torch.core.hw import H100_SXM
    from repro_torch.launch.dryrun import trace_step
    from repro_torch.launch.hlo import analyze
    from repro_torch.models import use_sharding

    with use_sharding(mesh, rules):
        gm, weights, _, _ = trace_step(cfg, shape, mesh, rules, accum, origins=True)
    gpn = H100_SXM.gpus_per_node
    return entries(gm, weights, gpn), analyze(gm, gpn, weights=weights)


def profile(arch: str, shape_name: str, tuned: bool = False, multi_pod: bool = False):
    """:func:`rank_cell` of a sweep cell on its production mesh (this
    process becomes rank 0 of a fake group of 256 or 512 ranks)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import production_rules
    from repro_torch.models.sharding import tuned_rules

    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = tuned_rules(arch, multi_pod) if tuned else production_rules(multi_pod=multi_pod)
    return rank_cell(get_config(arch), SHAPES[shape_name], mesh, rules)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("--tuned", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=18)
    args = ap.parse_args()
    ranked, stats = profile(args.arch, args.shape, args.tuned, args.multi_pod)
    print(f"== {args.arch} x {args.shape}: top collectives by executed link bytes "
          f"(of {stats.collectives.total_link_bytes:,} B a device, "
          f"{stats.collectives.total_count:,} calls) ==")
    for e in ranked[:args.top]:
        print(f"{e['link_bytes'] / 1e9:9.4f}GB x{e['count']:5d} P={e['group']:3d} "
              f"{e['op']:18s} {e['shape']:28s} {e['origin']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
