"""The port's dry-run held against real runs and unrolled loops, on the CPU
(the second file of ``test_torch_dryrun.py``'s, so that ``--dist
loadfile`` spreads the subprocess cells).

- granite-moe-1b-a400m ``train_4k`` on the 16 x 16 mesh of a fake 256-rank
  group (a subprocess): the MoE's counts trace on ``meta``, the microbatch
  loop is traced once and scaled, the gradients reduced onto ZeRO-1 shards;
- the scaled microbatch loop against the unrolled one, reduced
  granite-moe on a fake (2, 2) mesh, 2 and 4 microbatches: local FLOPs and
  every collective (op, group size, bytes) equal;
- fake against real: the same reduced step traced on a fake (2, 2) ``cpu``
  mesh and recorded on rank 0 of four ``gloo`` processes running it for
  real: the collectives in program order, local FLOPs and argument bytes
  equal, and ``CommDebugMode``'s count on rank 0 equal to the trace's;
- the sharded-attention repair: smollm-135m's config at 3 query and 3 KV
  heads on a (1, 4) mesh, where head alignment refuses to pad (4x the
  FLOPs) and the heads stay whole on every rank: the sharded forward and
  prefill equal the unsharded port within 1e-4 (logits and cache, as
  ``test_torch_distributed.py``) and the reference's forward within its
  ``REF_TOL`` (rtol 2e-4, atol 2e-5).  Before the repair the view of the
  column-sharded projection to (heads, head_dim) raised.

The spawned processes import this module by name: no JAX at its top level.
"""
import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import spawn
from test_torch_distributed import PG_S, JOIN_S, TOL, _errors, _full
from test_torch_dryrun import finish, run_sub

REF_TOL = dict(rtol=2e-4, atol=2e-5)
FAKE_VS_REAL = "granite-moe-1b-a400m", 8, 4  # reduced; seq, batch

MOE_CELL = """
from repro_torch.launch.dryrun import run_cell
r = run_cell("granite-moe-1b-a400m", "train_4k", multi_pod=False, save=False)
"""

SCALED_VS_UNROLLED = """
from repro_torch.configs import ShapeSuite, get_config
from repro_torch.launch.dryrun import build_step, record, step_stats
from repro_torch.launch.hlo import analyze
from repro_torch.launch.mesh import make_fake_mesh
from repro_torch.models import production_rules, use_sharding
mesh, rules = make_fake_mesh((2, 2)), production_rules()
cfg = get_config("granite-moe-1b-a400m").reduced()
shape = ShapeSuite("t", 16, 8, "train")
r = {}
with use_sharding(mesh, rules):
    for accum in (2, 4):
        scaled, _ = step_stats(cfg, shape, mesh, rules, accum=accum)
        unrolled = analyze(record(*build_step(cfg, shape, mesh, rules, accum=accum)))
        r[accum] = [{"flops": s.flops, "calls": sorted(s.collectives.calls),
                     "count": s.collectives.count_by_op,
                     "argument_bytes": s.argument_bytes} for s in (scaled, unrolled)]
"""

FAKE_SIDE = f"""
from repro_torch.configs import ShapeSuite, get_config
from repro_torch.launch.dryrun import step_stats
from repro_torch.launch.mesh import make_fake_mesh
from repro_torch.models import production_rules, use_sharding
arch, seq, batch = {FAKE_VS_REAL!r}
mesh, rules = make_fake_mesh((2, 2), device_type="cpu"), production_rules()
cfg = get_config(arch).reduced()
with use_sharding(mesh, rules):
    s, _ = step_stats(cfg, ShapeSuite("t", seq, batch, "train"), mesh, rules, accum=1)
r = {{"calls": s.collectives.calls, "flops": s.flops, "count": s.collectives.count_by_op,
      "argument_bytes": s.argument_bytes}}
"""


def _script(body: str) -> str:
    return body + "import json; print(json.dumps(r))\n"


@pytest.fixture(scope="module")
def subprocess_cells():
    """The fake-group cells, started together in subprocesses when the
    file's first test asks for them; each test waits for its own."""
    procs = {"moe": run_sub(_script(MOE_CELL)),
             "scaled": run_sub(_script(SCALED_VS_UNROLLED)),
             "fake": run_sub(_script(FAKE_SIDE))}
    return procs


def _done(subprocess_cells, name):
    got = subprocess_cells[name]
    if not isinstance(got, dict):
        subprocess_cells[name] = got = finish(got)
    return got


# ---------------------------------------------------------------------------
# Fake against real (four gloo processes)
# ---------------------------------------------------------------------------


def _real_rank():
    """Rank body: the reduced step of ``FAKE_VS_REAL`` on a (2, 2) gloo
    mesh, recorded while it runs for real, then run under
    ``CommDebugMode``."""
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs import ShapeSuite, get_config
    from repro_torch.launch.dryrun import build_step, record
    from repro_torch.launch.hlo import analyze, comm_counts
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.launch.specs import opt_shardings
    from repro_torch.models import init_params, param_shardings, production_rules, use_sharding
    from repro_torch.models.sharding import distribute, shard
    from repro_torch.optim import adamw

    arch, seq, batch = FAKE_VS_REAL
    cfg = get_config(arch).reduced()
    shape = ShapeSuite("t", seq, batch, "train")
    mesh, rules = make_mesh_for(dist.get_world_size(), 2, "cpu"), production_rules()
    g = torch.Generator().manual_seed(0)
    params = init_params(cfg, g, "cpu")
    opt = adamw()[0](params)
    data = {k: torch.randint(0, cfg.vocab, (batch, seq), generator=g, dtype=torch.int32)
            for k in ("inputs", "labels")}  # int32, as launch.specs.batch_specs
    with use_sharding(mesh, rules):
        fn, _ = build_step(cfg, shape, mesh, rules, accum=1)
        args = (distribute(params, param_shardings(params, mesh, rules)),
                distribute(opt, opt_shardings(cfg, params, opt, mesh, rules)),
                {k: shard(v, "batch", None) for k, v in data.items()})
        s = analyze(record(fn, args, mode="real"))
        with CommDebugMode() as comm:
            fn(*args)
    return {"calls": [list(c) for c in s.collectives.calls], "flops": s.flops,
            "argument_bytes": s.argument_bytes, "comm": comm_counts(comm)}


def test_fake_trace_equals_a_real_gloo_run(subprocess_cells):
    real = spawn(_real_rank, 4, device_type="cpu", join_timeout_s=JOIN_S, pg_timeout_s=PG_S)[0]
    fake = _done(subprocess_cells, "fake")
    assert fake["calls"] == real["calls"]
    assert len(real["calls"]) > 0 and {c[1] for c in real["calls"]} == {2}
    assert fake["flops"] == real["flops"] > 0
    assert fake["argument_bytes"] == real["argument_bytes"]
    assert real["comm"] == fake["count"]


# ---------------------------------------------------------------------------
# The sharded-attention repair (four gloo processes)
# ---------------------------------------------------------------------------

B, S = 4, 8


def _fault1_port_cfg():
    from repro_torch.configs import get_config

    return get_config("smollm-135m").reduced().with_(n_layers=2, n_heads=3,
                                                      n_kv_heads=3, d_model=48)


def _fault1_rank(tree, inputs):
    """Rank body: forward and prefill on (1, 4) against the unsharded port."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import forward, params_from_numpy, prefill, production_rules
    from repro_torch.models import use_sharding
    from repro_torch.models.attention import head_alignment
    from repro_torch.models.sharding import distribute, param_shardings
    from repro_torch.tree import leaves

    cfg = _fault1_port_cfg()
    mesh, rules = make_mesh_for(dist.get_world_size(), 4, "cpu"), production_rules()
    assert head_alignment(cfg, 4) == (1, 1, False)  # alignment refused
    params = params_from_numpy(tree, "cpu")
    x = torch.as_tensor(inputs)
    with torch.no_grad():
        ref_logits, _ = forward(cfg, params, x)
        ref_pl, ref_cache = prefill(cfg, params, x)
        with use_sharding(mesh, rules):
            sp = distribute(params, param_shardings(params, mesh, rules))
            logits, _ = forward(cfg, sp, x)
            pl, cache = prefill(cfg, sp, x)
    return {"forward": _errors([logits], [ref_logits]),
            "prefill": _errors([pl], [ref_pl]),
            "cache": _errors(leaves(cache), leaves(ref_cache)),
            "logits": _full(logits)}


@pytest.fixture(scope="module")
def fault1_reference():
    import jax

    from repro.configs import get_config as ref_get_config
    from repro.models import forward as ref_forward
    from repro.models import init_params as ref_init_params

    cfg = ref_get_config("smollm-135m").reduced().with_(n_layers=2, n_heads=3,
                                                         n_kv_heads=3, d_model=48)
    tree = jax.tree_util.tree_map(np.asarray, ref_init_params(cfg, jax.random.PRNGKey(0)))
    inputs = np.random.default_rng(0).integers(0, cfg.vocab, (B, S)).astype(np.int64)
    logits, _ = ref_forward(cfg, jax.tree_util.tree_map(jax.numpy.asarray, tree),
                            jax.numpy.asarray(inputs))
    return tree, inputs, np.asarray(logits)


def test_sharded_attention_with_unaligned_heads(fault1_reference, subprocess_cells):
    tree, inputs, ref_logits = fault1_reference
    res = spawn(_fault1_rank, 4, tree, inputs, device_type="cpu", join_timeout_s=JOIN_S,
                pg_timeout_s=PG_S)[0]
    for what in ("forward", "prefill", "cache"):
        assert res[what]["max_abs"] <= TOL, (what, res[what])
    np.testing.assert_allclose(res["logits"], ref_logits, **REF_TOL)


# ---------------------------------------------------------------------------
# The fake-group cells (last: the gloo runs above overlap them)
# ---------------------------------------------------------------------------


def test_moe_train_cell_traces_on_256_ranks(subprocess_cells):
    """granite-moe-1b-a400m ``train_4k``: 16 microbatches (the loop traced
    once and scaled), the expert counts on ``meta``, the gradients reduced
    onto their ZeRO-1 shards (reduce-scatters over the data axis)."""
    r = _done(subprocess_cells, "moe")
    assert r["n_chips"] == 256 and r["grad_accum"] == 16
    assert r["cost"]["flops_per_device"] > 0
    rf = r["roofline"]
    assert rf["dominant_term"] in ("compute", "memory", "collective") and rf["bound_s"] > 0
    assert r["collectives"]["count_by_op"]["reduce-scatter"] > 0


def test_scaled_microbatch_loop_counts_the_unrolled_one(subprocess_cells):
    """The counterpart of the reference's
    ``test_cost_analysis_counts_scan_body_once``: the loop recorded once
    and its marked body counted ``accum - 1`` more times gives the
    unrolled step's FLOPs and collectives exactly."""
    r = _done(subprocess_cells, "scaled")
    for accum in ("2", "4"):
        scaled, unrolled = r[accum]
        assert scaled["flops"] == unrolled["flops"] > 0, accum
        assert scaled["calls"] == unrolled["calls"], accum
        assert scaled["count"] == unrolled["count"], accum
        assert scaled["argument_bytes"] == unrolled["argument_bytes"], accum
    # the loop is really there: more microbatches, more collectives
    assert sum(r["4"][0]["count"].values()) > sum(r["2"][0]["count"].values())
