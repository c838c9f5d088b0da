"""The port's committed dry-run sweep (``experiments/dryrun_torch/``) is
complete: the counterpart of ``tests/test_dryrun.py::test_sweep_artifacts_complete``.

- every applicable (arch x shape x mesh) cell of ``repro_torch.configs``
  has its JSON, on 16 x 16 and 2 x 16 x 16 (64 cells), with its trace's
  seconds recorded and under the sweep's 10 minutes a cell;
- each decode cell's cache, written in place (``alias_bytes``), is the
  local shard of ``launch.specs.cache_shardings``' placement of that
  cell's cache (the KV sequence over the model axis): the reference's
  placement, computed here from the shapes alone.

Regenerate with ``PYTHONPATH=src python -m repro_torch.launch.dryrun --all
--both-meshes`` (CPU, no card).
"""
import json
import os

import pytest

from repro_torch.configs import ARCH_IDS, SHAPES, applicable, get_config
from repro_torch.launch.specs import cache_shardings, decode_specs, local_bytes_of
from repro_torch.models import production_rules, use_sharding

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "experiments", "dryrun_torch")
MESHES = {"pod16x16": {"data": 16, "model": 16},
          "pod2x16x16": {"pod": 2, "data": 16, "model": 16}}
CELLS = [(a, s, m) for a in ARCH_IDS for s in SHAPES for m in MESHES
         if applicable(get_config(a), SHAPES[s])]


class _Axes:
    """A mesh by its axis sizes alone (all ``launch.specs`` reads)."""

    def __init__(self, shape: dict):
        self.shape = shape


def _cell(arch, shape, mesh) -> dict:
    with open(os.path.join(OUT, f"{arch}__{shape}__{mesh}.json")) as f:
        return json.load(f)


def test_sweep_has_every_applicable_cell():
    assert len(CELLS) == 64
    missing = [c for c in CELLS if not os.path.exists(os.path.join(OUT, "__".join(c) + ".json"))]
    assert not missing, missing


@pytest.mark.parametrize("arch,shape,mesh", CELLS, ids=["__".join(c) for c in CELLS])
def test_cell_is_the_cells_trace(arch, shape, mesh):
    r = _cell(arch, shape, mesh)
    assert (r["arch"], r["shape"], r["n_chips"]) == (arch, shape, 512 if "2x" in mesh else 256)
    assert 0 < r["lower_s"] < 600  # traced within the sweep's 10 minutes
    assert r["cost"]["flops_per_device"] > 0
    assert r["roofline"]["dominant_term"] in ("compute", "memory", "collective")
    if SHAPES[shape].kind != "decode":
        return
    axes = _Axes(MESHES[mesh])
    rules = production_rules(multi_pod="2x" in mesh)
    cfg = get_config(arch)
    with use_sharding(axes, rules):  # KV heads aligned to the 16-wide model axis
        cache = decode_specs(cfg, SHAPES[shape])["cache"]
    want = local_bytes_of(cache, cache_shardings(cfg, cache, axes, rules))
    assert r["memory"]["alias_bytes"] == want
