"""The dry-run's time loops recorded a few steps and scaled, against the
same loops unrolled, on fake process groups (each in a subprocess, started
together; a fake group is a process's default group).

- xlstm-1.3b's reduced config (seven mLSTM blocks and an sLSTM block) at
  S = 64: the prefill (the sLSTM's forward, 64 positions) and the train
  step over 2 microbatches (the sLSTM's forward and backward, each time
  body inside the microbatch body) through ``step_stats``, scaled (3
  steps recorded) against ``unrolled=True``: local FLOPs, FLOPs by op,
  every collective (op, group size, bytes), counts by op and argument
  bytes equal exactly; the scaled step's temporary memory is not given
  (``None``: the recorded steps' saved tensors stand for every step's);
- the scaled prefill's FLOPs against ``FlopCounterMode`` on the same
  prefill run for real on the CPU (1, 1);
- the mLSTM's chunk loop alone: ``mlstm_block`` with 8-position chunks at
  S = 64 (8 chunks), forward and backward, the same equalities;
- both on a 1-rank (1, 1) and a 4-rank (2, 2) fake mesh;
- xlstm-1.3b's reduced train step on a (1, 8) mesh, whose model axis does
  not divide its 4 heads (as 16 does not on the production meshes);
- recurrentgemma-2b's reduced config on a 16-rank (4, 4) mesh: the RG-LRU
  gates' products are reduced onto the channels' placement, so the trace
  records no more nodes at S = 64 than at S = 32 beyond the program's own
  (before, DTensor's cost model recorded a scalar read a row of a
  strided-sharded gradient, and the full cell took 390 s to trace).

The reference's counterpart is ``test_cost_analysis_counts_scan_body_once``.
"""
import pytest

from test_torch_dryrun import finish, run_sub

LOOPS = """
import contextlib, json
import torch
from repro_torch.configs import ShapeSuite, get_config
from repro_torch.launch.dryrun import record, step_stats
from repro_torch.launch.hlo import analyze, node_weights
from repro_torch.launch.mesh import make_fake_mesh
from repro_torch.launch.specs import META
from repro_torch.models import param_shardings, production_rules, use_sharding
from repro_torch.models.loops import scaled_loops
from repro_torch.models.sharding import distribute, shard
from repro_torch.models.xlstm import init_mlstm, mlstm_block
from repro_torch.tree import leaves, tree_map
mesh, rules = make_fake_mesh(%r), production_rules()
cfg = get_config("xlstm-1.3b").reduced()

def row(s):
    return {"flops": s.flops, "by_op": s.flops_by_op, "calls": sorted(s.collectives.calls),
            "count": s.collectives.count_by_op, "argument_bytes": s.argument_bytes,
            "temp_bytes": s.temp_bytes}

def mlstm_grads(p, x):
    p = tree_map(lambda t: t.detach().requires_grad_(), p)
    x = x.detach().requires_grad_()
    with torch.enable_grad():
        loss = mlstm_block(cfg, p, x, chunk=8).float().sum()
        loss = loss.full_tensor() if hasattr(loss, "full_tensor") else loss
        return torch.autograd.grad(loss, [x] + leaves(p))

r = {}
with use_sharding(mesh, rules):
    for kind, accum in (("prefill", None), ("train", 2)):
        shape = ShapeSuite("t", 64, 4, kind)
        r[kind] = [row(step_stats(cfg, shape, mesh, rules, accum=accum, unrolled=u)[0])
                   for u in (False, True)]
    p = init_mlstm(cfg, torch.Generator(), META)
    p = distribute(p, param_shardings(p, mesh, rules))
    x = shard(torch.empty((4, 64, cfg.d_model), device=META), "batch", None, None)
    r["mlstm"] = []
    for unrolled in (False, True):
        with contextlib.ExitStack() as stack:
            marks = [] if unrolled else stack.enter_context(scaled_loops())
            gm = record(mlstm_grads, (p, x))
        r["mlstm"].append(row(analyze(gm, weights=node_weights(
            [(m.nodes, m.extra) for m in marks]))) | {"marks": [m.extra for m in marks],
                                                      "nodes": len(gm.graph.nodes)})
# the prefill run for real (no mesh) under FlopCounterMode
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.models import forward, init_params
g = torch.Generator().manual_seed(0)
x = torch.randint(0, cfg.vocab, (4, 64), generator=g, dtype=torch.int32)
with torch.no_grad(), FlopCounterMode(display=False) as fc:
    forward(cfg, init_params(cfg, g, "cpu"), x)
r["real_prefill_flops"] = fc.get_total_flops()
"""

RGLRU = """
from repro_torch.configs import ShapeSuite, get_config
from repro_torch.launch.dryrun import trace_step
from repro_torch.launch.mesh import make_fake_mesh
from repro_torch.models import production_rules, use_sharding
mesh, rules = make_fake_mesh((4, 4)), production_rules()
cfg = get_config("recurrentgemma-2b").reduced()
r = {}
for s in (32, 64):
    with use_sharding(mesh, rules):
        gm, _, _, _ = trace_step(cfg, ShapeSuite("t", s, 8, "train"), mesh, rules, accum=1)
    r[s] = {"recorded": gm.meta["recorded_nodes"], "live": len(gm.graph.nodes)}
"""
#: xlstm-1.3b's 4 heads on a model axis that does not divide them (16 in
#: the production meshes): the reduced config's 4 on a (1, 8) mesh
XLSTM_UNEVEN = """
from repro_torch.configs import ShapeSuite, get_config
from repro_torch.launch.dryrun import step_stats
from repro_torch.launch.mesh import make_fake_mesh
from repro_torch.models import production_rules, use_sharding
mesh, rules = make_fake_mesh((1, 8)), production_rules()
cfg = get_config("xlstm-1.3b").reduced()
with use_sharding(mesh, rules):
    s, _ = step_stats(cfg, ShapeSuite("t", 64, 8, "train"), mesh, rules, accum=1)
r = {"flops": s.flops, "count": s.collectives.count_by_op}
"""


def _script(body: str) -> str:
    return body + "import json; print(json.dumps(r))\n"


@pytest.fixture(scope="module")
def loop_cells():
    return {"1x1": run_sub(_script(LOOPS % ((1, 1),))),
            "2x2": run_sub(_script(LOOPS % ((2, 2),))),
            "rglru": run_sub(_script(RGLRU)),
            "xlstm_uneven": run_sub(_script(XLSTM_UNEVEN))}


def _done(cells, name):
    if not isinstance(cells[name], dict):
        cells[name] = finish(cells[name])
    return cells[name]


@pytest.mark.parametrize("mesh", ["1x1", "2x2"])
@pytest.mark.parametrize("what", ["prefill", "train", "mlstm"])
def test_scaled_time_loops_count_the_unrolled_ones(loop_cells, mesh, what):
    scaled, unrolled = _done(loop_cells, mesh)[what]
    assert scaled["flops"] == unrolled["flops"] > 0
    assert scaled["by_op"] == unrolled["by_op"]
    assert scaled["calls"] == unrolled["calls"]
    assert scaled["count"] == unrolled["count"]
    assert scaled["argument_bytes"] == unrolled["argument_bytes"]
    if mesh == "2x2" and what == "train":
        assert sum(scaled["count"].values()) > 0  # the step has collectives
    if what == "mlstm":
        # 8 chunks: 3 recorded, the marked one counted 5 more times; the
        # scaled graph is the smaller one
        assert scaled["marks"] == [5] and unrolled["marks"] == []
        assert scaled["nodes"] < unrolled["nodes"]


def test_scaled_prefill_counts_the_real_prefill(loop_cells):
    """The scaled trace's FLOPs are those a real run computes: the last
    mLSTM chunk's outgoing state, which nothing reads, is not computed
    (the trace drops dead nodes; a real run would compute it)."""
    r = _done(loop_cells, "1x1")
    assert r["prefill"][0]["flops"] == r["real_prefill_flops"] > 0


def test_recurrentgemma_trace_does_not_grow_with_the_sequence(loop_cells):
    r = _done(loop_cells, "rglru")
    dead = {s: v["recorded"] - v["live"] for s, v in r.items()}
    assert dead["64"] <= dead["32"], r


def test_xlstm_train_step_traces_where_the_model_axis_splits_its_heads(loop_cells):
    """The mLSTM's heads are flattened on each rank's shard: before, the
    backward of that view on a DTensor raised ``Cannot unflatten unevenly
    sharded tensor`` (xlstm-1.3b ``train_4k`` on 16 x 16)."""
    r = _done(loop_cells, "xlstm_uneven")
    assert r["flops"] > 0 and sum(r["count"].values()) > 0


@pytest.mark.parametrize("mesh", ["1x1", "2x2"])
@pytest.mark.parametrize("what", ["prefill", "train"])
def test_scaled_time_loops_leave_temporary_memory_unmeasured(loop_cells, mesh, what):
    """The recorded steps' saved tensors and outputs stand for all 64
    steps', which the liveness walk cannot see: a step with scaled loops
    gives no temporary bytes, the unrolled one its peak."""
    scaled, unrolled = _done(loop_cells, mesh)[what]
    assert scaled["temp_bytes"] is None
    assert unrolled["temp_bytes"] > 0
