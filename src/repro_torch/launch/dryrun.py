"""Multi-pod dry-run: trace every (architecture x input shape) on the
production meshes and extract the roofline terms on the H100's constants.

The port of :mod:`repro.launch.dryrun`.  Where the reference lowers and
compiles each step on 512 placeholder CPU devices and reads the
partitioned HLO, this process becomes rank 0 of a ``fake`` process group
of 256 or 512 ranks (:func:`~.mesh.make_production_mesh`), places the
parameters, optimizer state, batch and cache as DTensors of ``meta``
tensors, and records rank 0's program with ``make_fx`` (fake tensors):
local ops on its shards and DTensor's collectives.  :mod:`.hlo` reads
collective bytes, local FLOPs and live memory from that graph;
:mod:`.roofline` turns them into the three terms.  Nothing is computed and
no card is needed.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k --multi-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes

Each cell writes experiments/dryrun_torch/<arch>__<shape>__<mesh>.json
with the reference's keys.  ``lower_s`` is the trace's seconds and
``compile_s`` 0 (nothing is compiled).

How the traces differ from the reference's lowering:
- decode takes the position as a Python int (``seq_len - 1``): the port's
  ``decode_attention`` reads it on the host, which a ``meta`` tensor
  cannot give;
- prefill runs ``forward(..., use_kernels=True)``, the card's route:
  flash attention is its custom op, whose fake implementation gives the
  shape and whose FLOP formula counts the tiles the kernel computes;
- the graph unrolls the layer loop, but records every other loop once and
  counts its body for the runs it stands for, the counterpart of the
  reference's ``execution_counts``: a train step's microbatch loop is
  traced on one microbatch (forward, backward, the gradient reduction and
  the update), its body counted ``accum - 1`` more times; each time loop
  (the mLSTM's chunks, the sLSTM's positions;
  :class:`~repro_torch.models.loops.TimeLoop`) runs three steps, the
  middle one counted for the steps not run;
- decode's cache is placed as the reference places it
  (``launch.specs.cache_shardings``: the KV sequence over the model
  axis), and ``decode_attention`` attends it flash-decoding style, each
  model rank its slice of the sequence, combined by two all-reduces.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback
from dataclasses import replace
from pathlib import Path

import torch

from ..configs import ARCH_IDS, SHAPES, applicable, get_config
from ..core.hw import H100_SXM
from ..models import decode_step, forward, lm_loss, param_shardings, production_rules, use_sharding
from ..models.loops import recorded_nodes, scaled_loops
from ..models.sharding import axis_size, distribute, shard, tuned_rules
from ..optim import adamw
from ..optim.schedule import warmup_cosine
from ..tree import leaves, tree_map, unflatten
from .hlo import ProgramStats, analyze, node_weights
from .mesh import make_production_mesh
from .roofline import roofline_report
from .specs import (abstract_opt_state, abstract_params, batch_specs, cache_shardings,
                    decode_specs, opt_shardings)

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"


def _n_devices(mesh) -> int:
    """Devices of a ``DeviceMesh``, or of any object with ``.devices.size``
    (a JAX mesh)."""
    return mesh.devices.size if hasattr(mesh, "devices") else mesh.size()


def grad_accum_steps(cfg, shape, mesh, rules=None) -> int:
    """Microbatching so per-device live activations stay within ~6 GB.

    Standard production practice: the global batch is split into
    microbatches run inside the step, gradients accumulated — trades
    one more traversal of the weights for a bounded activation footprint.
    With sequence parallelism the saved residuals are seq-sharded over the
    model axis, so far fewer microbatches are needed.
    """
    dp = _n_devices(mesh) // 16  # model axis is 16 on both meshes
    tok_dev = shape.global_batch * shape.seq_len / max(dp, 1)
    act_bytes = tok_dev * cfg.d_model * cfg.n_layers * 2 * 2  # carries, bf16
    if rules is not None and rules.sequence:
        act_bytes /= axis_size(mesh, rules.sequence)
    # the f32 logits + log-softmax of one microbatch are often the peak
    vocab_dev = cfg.vocab / (16 if cfg.vocab % 16 == 0 else 1)
    logit_bytes = tok_dev * vocab_dev * 6  # f32 logits + softmax temps
    accum = 1
    # microbatches must still cover the data axis (>= 1 sequence/device)
    max_accum = max(shape.global_batch // dp, 1)
    # 1.5 GB live-activation target: gathered f32 buffers (2-4 alive
    # during remat-backward) plus carries must stay well under HBM
    while max(act_bytes, logit_bytes) / accum > 1.5e9 and accum < max_accum:
        accum *= 2
    return accum


def value_and_grad(cfg, params, batch):
    """``(loss, grads)`` of ``lm_loss`` by autograd; on a mesh the loss is
    made whole first and each gradient keeps the placement autograd gives
    it (a partial sum where ranks saw different tokens)."""
    p = tree_map(lambda t: t.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss = lm_loss(cfg, p, batch)
        if hasattr(loss, "full_tensor"):
            loss = loss.full_tensor()
        # a leaf the loss does not use (olmo-1b's non-parametric norms)
        # gets a zero gradient, as jax.grad gives it
        grads = torch.autograd.grad(loss, leaves(p), allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), unflatten(params, list(grads))


def _microbatch(x, i: int, accum: int):
    """Microbatch ``i`` of ``accum``: the ``i``-th part of each rank's own
    rows, so a microbatch stays sharded as the batch is (the reference
    reshapes the global batch; the microbatches hold other rows, the sum
    over them is the same)."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        loc = x.to_local()
        n = loc.shape[0] // accum
        return DTensor.from_local(loc[i * n:(i + 1) * n], x.device_mesh, x.placements,
                                  run_check=False)
    n = x.shape[0] // accum
    return x[i * n:(i + 1) * n]


def accumulated_grads(cfg, params, batch, accum: int, reduce=lambda g: g,
                      mark_body=None):
    """Mean loss + grads over ``accum`` microbatches (a Python loop, the
    reference's ``lax.scan``), summed in float32.  ``reduce`` maps the
    summed gradient tree onto its reduced placements once, after the loop
    (the data-parallel reduction), before the division by ``accum``.

    With ``mark_body`` (how :func:`step_stats` traces the loop once),
    ``batch`` is one microbatch: the loop runs once and calls
    ``mark_body()`` at the end of its body."""
    if accum <= 1:
        loss, grads = value_and_grad(cfg, params, batch)
        return loss, reduce(grads)
    runs = 1 if mark_body else accum
    loss_sum, gacc = None, None
    for i in range(runs):
        mb = tree_map(lambda x: _microbatch(x, i, runs), batch)
        loss, grads = value_and_grad(cfg, params, mb)
        g32 = tree_map(lambda g: g.float(), grads)
        if gacc is None:
            loss_sum, gacc = loss, g32
        else:
            loss_sum, gacc = loss_sum + loss, tree_map(torch.add, gacc, g32)
        if mark_body:
            mark_body()
    return loss_sum / accum, tree_map(lambda g: g / accum, reduce(gacc))


def _redistribute(tree, like):
    """Each DTensor of ``tree`` on the placements of its leaf in ``like``."""
    return unflatten(tree, [t.redistribute(w.device_mesh, w.placements)
                            for t, w in zip(leaves(tree), leaves(like))])


def placed_batch(cfg, shape) -> dict:
    """The cell's batch, sharded over the rules' batch axes."""
    return {k: shard(v, "batch", *(None,) * (v.dim() - 1))
            for k, v in batch_specs(cfg, shape).items()}


def build_step(cfg, shape, mesh, rules, accum: int | None = None, mark_body=None):
    """``(fn, args)`` of the cell's step on DTensors of ``meta`` tensors
    (call under ``use_sharding(mesh, rules)``).

    train: ``accumulated_grads`` over ``accum`` microbatches (default
    :func:`grad_accum_steps`), the gradients reduced onto the optimizer
    state's ZeRO-1 placements (a reduce-scatter over the data axes), AdamW
    on those shards and the new parameters gathered back onto their own
    placements.  prefill: ``forward`` on the kernel route.  decode:
    ``decode_step`` at position ``seq_len - 1``.  ``mark_body``: see
    :func:`accumulated_grads` (``shape`` is then one microbatch's)."""
    params_abs = abstract_params(cfg)
    params = distribute(params_abs, param_shardings(params_abs, mesh, rules))

    if shape.kind == "train":
        opt_abs = abstract_opt_state(cfg, params_abs)
        opt = distribute(opt_abs, opt_shardings(cfg, params_abs, opt_abs, mesh, rules))
        _, update = adamw(lr=warmup_cosine(3e-4, 100, 10_000))
        accum = grad_accum_steps(cfg, shape, mesh, rules) if accum is None else accum

        def train_step(params, opt, batch):
            loss, grads = accumulated_grads(
                cfg, params, batch, accum, reduce=lambda g: _redistribute(g, opt.m),
                mark_body=mark_body)
            new, opt = update(grads, opt, _redistribute(params, opt.m))
            return loss, _redistribute(new, params), opt

        return train_step, (params, opt, placed_batch(cfg, shape))

    if shape.kind == "prefill":

        def prefill_step(params, batch):
            logits, _ = forward(cfg, params, batch["inputs"])
            return logits

        return prefill_step, (params, placed_batch(cfg, shape))

    # the cache as the reference places it: KV sequence over the model axis
    specs = decode_specs(cfg, shape)
    cache = distribute(specs["cache"], cache_shardings(cfg, specs["cache"], mesh, rules))
    index = shape.seq_len - 1

    def serve_step(params, cache, tokens):
        return decode_step(cfg, params, cache, tokens, index)

    tokens = shard(specs["tokens"], "batch", *(None,) * (specs["tokens"].dim() - 1))
    return serve_step, (params, cache, tokens)


def _keep_origins(graph) -> None:
    """Each node ``graph`` creates from here on keeps the frames of
    ``repro_torch`` it was created under, outermost first, as
    ``node.meta["origin"]`` (``"models/attention.py:120 _align_weights"``):
    ``make_fx``'s own stack traces end in PyTorch's frames (DTensor's
    redistribution, for a collective)."""
    create = graph.create_node

    def create_node(*args, **kwargs):
        node = create(*args, **kwargs)
        frames, f = [], sys._getframe(1)
        while f is not None:
            name = f.f_code.co_filename
            if "/repro_torch/" in name:
                frames.append(f"{name.split('repro_torch/')[-1]}:{f.f_lineno} "
                              f"{f.f_code.co_name}")
            f = f.f_back
        node.meta["origin"] = frames[::-1]
        return node

    graph.create_node = create_node


def record(fn, args, mode: str = "fake", origins: bool = False) -> torch.fx.GraphModule:
    """This rank's program of ``fn(*args)``: ``make_fx`` (fake tensors;
    with ``mode="real"`` the ops and collectives run for real as they are
    recorded) of the function of the rank's local shards.  Each DTensor
    argument enters as its local tensor (contiguous, as a rank holds it)
    and is wrapped back into its DTensor inside (``from_local``, no
    communication), so every recorded op, DTensor's collectives included,
    acts on local tensors; DTensor results leave as their local tensors.
    ``origins``: each node keeps the model code it came from
    (:func:`_keep_origins`)."""
    from torch.distributed.tensor import DTensor
    from torch.fx.experimental.proxy_tensor import make_fx

    flat = leaves(args)
    specs = [(t.device_mesh, t.placements, t.shape, t.stride())
             if isinstance(t, DTensor) else None for t in flat]
    local = [t.to_local().contiguous() if s else t for t, s in zip(flat, specs)]

    def on_locals(*ts):
        if origins:
            from torch.fx.experimental.proxy_tensor import get_proxy_mode

            _keep_origins(get_proxy_mode().tracer.graph)
        wrapped = [DTensor.from_local(t, s[0], s[1], run_check=False, shape=s[2],
                                      stride=s[3]) if s else t
                   for t, s in zip(ts, specs)]
        out = fn(*unflatten(args, wrapped))
        return [o.to_local() if isinstance(o, DTensor) else o
                for o in leaves(out) if isinstance(o, torch.Tensor)]

    gm = make_fx(on_locals, tracing_mode=mode)(*local)
    gm.graph.__dict__.pop("create_node", None)
    # a node nothing uses is not part of the program: some PyTorch versions
    # (2.11) record the fake runs DTensor's sharding propagation makes to
    # learn an op's output shape; a write in place is kept (so model code
    # computes no output nobody reads, or the trace counts less than a real
    # run).  How many nodes were recorded is the trace's cost
    # (``meta["recorded_nodes"]``).
    gm.meta["recorded_nodes"] = len(gm.graph.nodes)
    gm.graph.eliminate_dead_code()
    return gm


def local_bytes(tree) -> int:
    """Bytes of the tensors of ``tree`` as this rank holds them (a
    DTensor's local shard)."""
    total = 0
    for t in leaves(tree):
        if isinstance(t, torch.Tensor):
            loc = t.to_local() if hasattr(t, "to_local") else t
            total += loc.numel() * loc.element_size()
    return total


def trace_step(cfg, shape, mesh, rules, accum: int | None = None,
               unrolled: bool = False, origins: bool = False):
    """``(gm, weights, args, accum)``: :func:`record`'s graph of the cell's
    step on ``mesh`` (under ``use_sharding``), with each node's run count
    (:func:`.hlo.node_weights`), the arguments it was traced on, and the
    microbatches.

    Loops other than the layers' are recorded once and scaled.  A train step over ``accum > 1``
    microbatches is recorded with its loop run once (on one microbatch,
    ``args`` that microbatch's) and the loop's body, marked in the graph,
    counted ``accum - 1`` more times.  Each time loop
    (:class:`~repro_torch.models.loops.TimeLoop`: the mLSTM's chunks, the
    sLSTM's positions) runs three steps
    (:data:`~repro_torch.models.loops.STEPS`), the middle
    one marked and counted for the steps not run; a time-loop body inside
    the microbatch body counts for every microbatch
    (``gm.meta["scaled_loops"]``: how many were scaled).  ``unrolled``
    runs every step of the time loops instead.  ``origins``:
    see :func:`record` (the profiler's)."""
    if shape.kind != "train":
        accum = 1
    elif accum is None:
        accum = grad_accum_steps(cfg, shape, mesh, rules)
    micro = replace(shape, global_batch=shape.global_batch // accum) if accum > 1 else shape
    marks = []
    with contextlib.ExitStack() as stack:
        loop_marks = [] if unrolled else stack.enter_context(scaled_loops())
        fn, args = build_step(cfg, micro, mesh, rules, accum=accum, mark_body=(
            (lambda: marks.append((recorded_nodes(), accum - 1))) if accum > 1 else None))
        gm = record(fn, args, origins=origins)
    gm.meta["scaled_loops"] = len(loop_marks)
    marks += [(m.nodes, m.extra) for m in loop_marks]
    return gm, node_weights(marks), args, accum


def step_stats(cfg, shape, mesh, rules, accum: int | None = None,
               unrolled: bool = False) -> tuple[ProgramStats, int]:
    """``(stats, accum)`` of the cell's step (:func:`trace_step`), read by
    :func:`.hlo.analyze`.  FLOPs and collectives are the unrolled step's
    exactly: what the scaling leaves out or adds (the accumulation's casts
    and adds, the time loops' padding of their outputs) computes no FLOP
    and moves nothing.  Bytes accessed count that padding (a cat to the
    loop's full length).  Argument bytes are the whole step's.  Temporary
    memory is the recorded graph's peak, one microbatch's; with scaled
    time loops it is ``None``: every step's outputs (and in a train step
    its saved tensors) outlive the loop, and the graph holds three
    steps'."""
    gm, weights, args, accum = trace_step(cfg, shape, mesh, rules, accum, unrolled)
    stats = analyze(gm, H100_SXM.gpus_per_node, weights=weights)
    if accum > 1:
        stats.argument_bytes = local_bytes(args[:2] + (placed_batch(cfg, shape),))
    if gm.meta["scaled_loops"]:
        stats.temp_bytes = None
    return stats, accum


def run_cell(arch: str, shape_name: str, multi_pod: bool, save: bool = True,
             tuned: bool = False) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if not applicable(cfg, shape):
        return {"arch": arch, "shape": shape_name, "skipped": True,
                "reason": "long_500k requires sub-quadratic attention"}
    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = tuned_rules(arch, multi_pod) if tuned else production_rules(multi_pod=multi_pod)
    t0 = time.time()
    with use_sharding(mesh, rules):
        stats, accum = step_stats(cfg, shape, mesh, rules)
    t_trace = time.time() - t0
    mesh_name = ("pod2x16x16" if multi_pod else "pod16x16") + ("-tuned" if tuned else "")
    result = cell_result(cfg, shape, mesh, stats, t_trace)
    result.update(arch=arch, shape=shape_name, mesh=mesh_name, grad_accum=accum)
    if save:
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        path = OUT_DIR / f"{arch}__{shape_name}__{mesh_name}.json"
        path.write_text(json.dumps(result, indent=2))
    return result


def cell_result(cfg, shape, mesh, stats: ProgramStats, t_trace: float) -> dict:
    """The reference's result keys (and the port's own beside them) for one
    traced step, with its roofline terms on :data:`H100_SXM`."""
    coll = stats.collectives
    result = {
        "arch": cfg.name,
        "shape": shape.name,
        "mesh": "x".join(str(n) for n in mesh.shape),
        "n_chips": _n_devices(mesh),
        "mesh_shape": dict(zip(mesh.mesh_dim_names, mesh.shape)),
        "kind": shape.kind,
        "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "chip": H100_SXM.name,
        "lower_s": round(t_trace, 1),  # make_fx's trace
        "compile_s": 0.0,  # nothing is compiled
        "memory": {
            "argument_bytes": stats.argument_bytes,
            "output_bytes": stats.output_bytes,
            "temp_bytes": stats.temp_bytes,
            "code_bytes": 0,  # an FX graph holds no generated code
            "alias_bytes": stats.alias_bytes,
        },
        "cost": {
            "flops_per_device": float(stats.flops),
            "bytes_per_device": float(stats.bytes_accessed),
            "flops_by_op": stats.flops_by_op,
        },
        "collectives": {
            "bytes_by_op": coll.bytes_by_op,
            "link_bytes_by_op": coll.link_bytes_by_op,
            "count_by_op": coll.count_by_op,
            "total_bytes_per_device": coll.total_bytes,
            "link_bytes_per_device": coll.total_link_bytes,
            "group_sizes_by_op": {op: {str(p): n for p, n in sorted(g.items())}
                                  for op, g in coll.group_sizes_by_op.items()},
            "link_bytes_by_span": dict(coll.link_bytes_by_span),
        },
        "kernel_calls": stats.kernel_calls,  # the port's own ops (flash)
        # loops are counted with their runs already (step_stats): no trip count
        "while_trip_counts": [],
    }
    result["roofline"] = roofline_report(cfg, shape, result)
    return result


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--tuned", action="store_true",
                    help="hillclimbed sharding rules (§Perf) instead of baseline")
    args = ap.parse_args()

    meshes = (False, True) if args.both_meshes else (args.multi_pod,)
    if args.all:
        pairs = [(arch, shape) for arch in ARCH_IDS for shape in SHAPES]
    elif args.arch and args.shape:
        pairs = [(args.arch, args.shape)]
    else:
        ap.error("--arch/--shape or --all")

    import torch.distributed as dist

    failures = 0
    # one fake group at a time: every cell of one mesh, then the other
    for mp in meshes:
        for arch, shape in pairs:
            tag = f"{arch} x {shape} x {'2x16x16' if mp else '16x16'}"
            try:
                r = run_cell(arch, shape, mp, tuned=args.tuned)
                if r.get("skipped"):
                    print(f"SKIP {tag}: {r['reason']}", flush=True)
                    continue
                rf = r["roofline"]
                print(
                    f"OK   {tag}: trace={r['lower_s']}s "
                    f"flops/dev={r['cost']['flops_per_device']:.3e} "
                    f"coll={r['collectives']['total_bytes_per_device']:.3e}B "
                    f"bound={rf['dominant_term']}",
                    flush=True,
                )
            except Exception as e:  # the sweep reports every cell
                failures += 1
                print(f"FAIL {tag}: {type(e).__name__}: {e}", flush=True)
                traceback.print_exc()
        if dist.is_initialized():
            dist.destroy_process_group()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
