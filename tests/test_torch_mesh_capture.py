"""What lets the port capture its runs over a mesh as CUDA graphs, checked
on the CPU at reduced widths:

- *No host read.*  The function a graph records over a DTensor mesh
  (:class:`repro_torch.capture.LocalShards`: the step of each rank's local
  shards, DTensors wrapped back inside) run under ``FakeTensorMode``, which
  refuses a data-dependent output: ``launch.train``'s step on a (1, 1)
  mesh (smollm-135m, and granite-moe in bf16, the MoE dtype captured) and
  ``decode_step`` over the heads-placed cache with a 0-d position.  A
  planted ``.item()`` fails the same check, so the check can fail.
  ``Program.run`` and ``train_step`` with ``mesh=["cpu", "cpu"]`` (the
  Parallel Pipeline's two groups) under ``FakeTensorMode`` too.
- *Parity.*  The recorded function run for real on a world-1 ``gloo`` mesh
  in this process: ``torch.equal`` to the DTensor step it was made from
  (loss and every leaf of the state; the decode logits and the cache), and
  within the reference's tolerances of its jitted step from the same
  seeded numpy weights (``tests/test_torch_distributed_train.py``'s rtol
  1e-4, atol 1e-5 for the training step; ``tests/test_torch_lm_kinds.py``'s
  decode tolerance).
- *The rule.*  :func:`repro_torch.api.captures_on` and the LM's
  ``captures_mesh`` / ``sequence_placed`` on real placements.

The captures themselves run on the card (``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import DataDependentOutputException, FakeTensorMode

import repro.models.transformer as ref_tf
import repro_torch
import repro_torch.models.transformer as tf
from repro.configs import get_config as ref_get_config
from repro.launch.train import build_trainer as ref_build_trainer
from repro_torch.api import captures_on
from repro_torch.capture import LocalShards, local
from repro_torch.configs import get_config
from repro_torch.core.schedule import ModelSchedule
from repro_torch.data import LMDataPipeline
from repro_torch.gnn import GNNConfig, make_node_classification_task
from repro_torch.graphs import from_edges
from repro_torch.launch import train
from repro_torch.models import init_params, param_shardings, params_from_numpy, production_rules
from repro_torch.models.sharding import distribute, use_sharding
from repro_torch.tree import leaves, tree_map

TRAIN_TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_torch_distributed_train.py
DECODE_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_torch_lm_kinds.py's decode tolerance
#: the archs whose mesh steps are traced: a dense one, and the MoE in bf16
ARCHS = [("smollm-135m", None), ("granite-moe-1b-a400m", "bfloat16")]


@pytest.fixture(scope="module")
def mesh():
    """A (1, 1) ``gloo`` mesh over a world-1 group in this process."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_process_group, make_mesh_for

    fresh = not dist.is_initialized()
    init_process_group("cpu")
    yield make_mesh_for(1, 1, "cpu")
    if fresh:
        dist.destroy_process_group()


def on_mesh(mesh, params):
    return distribute(params, param_shardings(params, mesh, production_rules()))


def trainer(mesh, arch, dtype, seed=0):
    """``launch.train``'s step on ``mesh`` for reduced ``arch``, its state
    (DTensors) and a batch."""
    cfg = get_config(arch).reduced(**({"dtype": dtype} if dtype else {}))
    params = on_mesh(mesh, init_params(cfg, torch.Generator().manual_seed(seed), "cpu"))
    init_opt, step = train.build_trainer(cfg, mesh, production_rules(), lr=1e-3,
                                         total_steps=10)
    data = LMDataPipeline(cfg, 2, 8, seed=seed, device="cpu")
    return step, (params, init_opt(params), None), data.peek(0)


def recorded_step(step, state, batch):
    """What ``TrainStep`` captures on a mesh: the step with its state written
    in place, as a function of the local tensors of its arguments; and
    those arguments (their own copies)."""
    args = (tree_map(torch.clone, state), batch)
    flat = leaves(args)
    return LocalShards(step.flat_step(args), flat), flat


def run_faked(fn, flat):
    """``fn`` (a :class:`LocalShards`) on fake copies of the local tensors of
    ``flat``: any host read raises."""
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        return fn(*(mode.from_tensor(local(t)) for t in flat))


# ---------------------------------------------------------------------------
# No host read in what a mesh graph records
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,dtype", ARCHS)
def test_mesh_train_step_reads_nothing_on_the_host(mesh, arch, dtype):
    step, state, batch = trainer(mesh, arch, dtype)
    step.eager(*state, batch)  # the tables the model caches made real
    fn, flat = recorded_step(step, state, batch)
    (loss,) = run_faked(fn, flat)
    assert loss.shape == () and fn.out_specs == [None]  # the loss, made whole


@pytest.mark.parametrize("arch,dtype", ARCHS)
def test_a_planted_host_read_fails_the_check(mesh, arch, dtype):
    """The same check on the step with one ``.item()`` added raises: the
    check above can fail."""
    step, state, batch = trainer(mesh, arch, dtype)
    step.eager(*state, batch)
    args = (tree_map(torch.clone, state), batch)
    inner = step.flat_step(args)

    def planted(*flat):
        loss = inner(*flat)
        loss.item()
        return loss

    with pytest.raises(DataDependentOutputException):
        run_faked(LocalShards(planted, leaves(args)), leaves(args))


def decoder_function(cfg, params, cache, tokens):
    """What ``transformer.decoder`` captures: ``decode_step`` over
    ``cache`` as a function of the token and a 0-d position."""
    index = torch.zeros((), dtype=torch.int64)
    return LocalShards(lambda tok, i: tf.decode_step(cfg, params, cache, tok, i)[0],
                       [tokens, index])


@pytest.mark.parametrize("arch,dtype", ARCHS)
def test_mesh_decode_step_reads_nothing_on_the_host(mesh, arch, dtype):
    cfg = get_config(arch).reduced(**({"dtype": dtype} if dtype else {}))
    sp = on_mesh(mesh, init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    tok = torch.zeros((2, 1), dtype=torch.int32)
    with torch.no_grad(), use_sharding(mesh, production_rules()):
        tf.decode_step(cfg, sp, tf.init_cache(cfg, 2, 8, device="cpu"), tok, 0)  # rope table
        with FakeTensorMode(allow_non_fake_inputs=True) as mode:
            cache = tf.init_cache(cfg, 2, 8, device="cpu")
            assert not tf.sequence_placed(cfg, cache)
            fn = decoder_function(cfg, sp, cache, tok)
            (logits,) = fn(mode.from_tensor(tok), mode.from_tensor(torch.tensor(3)))
        assert logits.shape == (2, 1, cfg.vocab)
        assert fn.out_specs[0] is not None  # the logits leave as a DTensor's shard


# ---------------------------------------------------------------------------
# The Parallel Pipeline's two groups: Program.run and train_step
# ---------------------------------------------------------------------------


def pp_program(use_pallas):
    rng = np.random.default_rng(3)
    g = from_edges(60, rng.integers(0, 60, 200), rng.integers(0, 60, 200))
    cfg = GNNConfig("gcn", f_in=12, hidden=8, n_classes=4, use_pallas=use_pallas)
    prog = repro_torch.compile(cfg, graph=g, device="cpu",
                               schedule=ModelSchedule.from_policies("pp", "AC", cfg.dims,
                                                                    band_size=16))
    x = torch.as_tensor(rng.normal(size=(60, 12)).astype(np.float32))
    return prog, g, prog.init(torch.Generator().manual_seed(0)), x


@pytest.mark.parametrize("use_pallas", [False, True])
def test_pp_run_on_two_groups_reads_nothing_on_the_host(use_pallas):
    prog, _, params, x = pp_program(use_pallas)
    want = prog.run(params, x, mesh=["cpu", "cpu"])
    if not use_pallas:  # the eager tier: the one-device fallback, bit for bit
        assert torch.equal(want, prog.run(params, x))
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        out = prog.run(tree_map(mode.from_tensor, params), mode.from_tensor(x),
                       mesh=["cpu", "cpu"])
        assert out.shape == want.shape and out.dtype == want.dtype


def test_pp_train_step_on_two_groups_reads_nothing_on_the_host():
    prog, g, params, _ = pp_program(False)
    task = make_node_classification_task(g, 12, 4, device="cpu")
    want_loss, want = prog.train_step(params, *task, mesh=["cpu", "cpu"])
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        loss, new = prog.train_step(tree_map(mode.from_tensor, params),
                                    *(mode.from_tensor(t) for t in task), mesh=["cpu", "cpu"])
        assert loss.shape == want_loss.shape
        assert [{k: v.shape for k, v in layer.items()} for layer in new] == \
            [{k: v.shape for k, v in layer.items()} for layer in want]


# ---------------------------------------------------------------------------
# Parity: the recorded function for real on a world-1 gloo mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,dtype", ARCHS)
def test_recorded_mesh_step_equals_the_dtensor_step(mesh, arch, dtype):
    """Three steps of the recorded function (the state written into its own
    buffers, as a replay writes them) against three of the uncaptured
    DTensor step: the loss and every leaf's shard ``torch.equal``."""
    step, state, batch = trainer(mesh, arch, dtype)
    data = LMDataPipeline(step.cfg, 2, 8, seed=0, device="cpu")
    fresh = state
    args = (tree_map(torch.clone, state), batch)
    flat = leaves(args)
    fn = LocalShards(step.flat_step(args), flat)
    buffers = [local(t) for t in flat]
    n = len(leaves(state))
    for s in range(3):
        batch = data.peek(s)
        for buf, t in zip(buffers[n:], leaves(batch)):
            buf.copy_(t)
        loss = fn.results(fn(*buffers))
        want_loss, *fresh = step.eager(*fresh, batch)
        assert torch.equal(loss, want_loss), s
        assert all(torch.equal(a, local(b)) for a, b in zip(buffers[:n], leaves(fresh))), s
    assert int(buffers[len(leaves(state[0]))]) == 3  # the step counter, in place


def test_recorded_mesh_step_matches_the_reference(mesh):
    """One recorded step on the mesh from the reference's seeded weights
    (carried across by ``params_from_numpy``) against the reference's
    jitted step on the same weights and batch: the loss, the parameters
    and both moments within rtol 1e-4, atol 1e-5."""
    arch = "smollm-135m"
    cfg, ref_cfg = get_config(arch).reduced(), ref_get_config(arch).reduced()
    tree = jax.tree_util.tree_map(np.asarray, ref_tf.init_params(ref_cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32)
             for k in ("inputs", "labels")}
    ref_init, ref_step = ref_build_trainer(ref_cfg, None, None, lr=1e-3, total_steps=10)
    ref_params = jax.tree_util.tree_map(jnp.asarray, tree)
    ref_loss, ref_p, ref_o, _ = ref_step(ref_params, ref_init(ref_params), None,
                                         {k: jnp.asarray(v) for k, v in batch.items()})

    params = on_mesh(mesh, params_from_numpy(tree, "cpu"))
    init_opt, step = train.build_trainer(cfg, mesh, production_rules(), lr=1e-3,
                                         total_steps=10)
    fn, flat = recorded_step(step, (params, init_opt(params), None),
                             {k: torch.as_tensor(v) for k, v in batch.items()})
    loss = fn.results(fn(*(local(t) for t in flat)))
    np.testing.assert_allclose(float(loss), float(ref_loss), **TRAIN_TOL)
    ours = [local(t) for t in flat[:len(leaves(params)) * 3 + 1]]
    want = [np.asarray(t) for t in jax.tree_util.tree_leaves((ref_p, ref_o))]
    assert len(ours) == len(want)
    order = leaves((params, init_opt(params)))
    assert [tuple(t.shape) for t in order] == [w.shape for w in want]
    for i, (a, b) in enumerate(zip(ours, want)):
        np.testing.assert_allclose(a.float().numpy(), b.astype(np.float32), **TRAIN_TOL,
                                   err_msg=f"leaf {i}")


@pytest.mark.parametrize("arch,dtype", ARCHS)
def test_recorded_mesh_decode_equals_the_dtensor_decode(mesh, arch, dtype):
    """Six positions through the recorded decode function (0-d position,
    the heads-placed DTensor cache written through its shards) against
    ``decode_step`` with the int position on a cache of its own: the
    logits and every cache leaf ``torch.equal``."""
    cfg = get_config(arch).reduced(**({"dtype": dtype} if dtype else {}))
    sp = on_mesh(mesh, init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    toks = torch.randint(0, cfg.vocab, (2, 6), generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    with torch.no_grad(), use_sharding(mesh, production_rules()):
        by_int, by_graph = (tf.init_cache(cfg, 2, 6, device="cpu") for _ in range(2))
        fn = decoder_function(cfg, sp, by_graph, toks[:, :1])
        for i in range(6):
            want = tf.decode_step(cfg, sp, by_int, toks[:, i:i + 1], i)[0]
            got = fn.results(fn(toks[:, i:i + 1], torch.tensor(i)))
            assert type(got) is type(want) and got.placements == want.placements
            assert torch.equal(local(got), local(want)), i
    assert all(torch.equal(local(a), local(b)) for a, b in zip(leaves(by_int), leaves(by_graph)))


def test_recorded_mesh_decode_matches_the_reference(mesh):
    """The recorded decode function on the mesh against the reference's
    jitted ``decode_step`` on the same weights: every position's logits
    within the decode tolerance."""
    arch = "smollm-135m"
    cfg, ref_cfg = get_config(arch).reduced(), ref_get_config(arch).reduced()
    rp = ref_tf.init_params(ref_cfg, jax.random.PRNGKey(5))
    sp = on_mesh(mesh, params_from_numpy(jax.tree_util.tree_map(np.asarray, rp), "cpu"))
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (2, 6)).astype(np.int32)
    ref_cache = ref_tf.init_cache(ref_cfg, 2, 6)
    ref_step = jax.jit(lambda c, t, i: ref_tf.decode_step(ref_cfg, rp, c, t, i))
    with torch.no_grad(), use_sharding(mesh, production_rules()):
        cache = tf.init_cache(cfg, 2, 6, device="cpu")
        fn = decoder_function(cfg, sp, cache, torch.as_tensor(toks[:, :1]))
        for i in range(6):
            got = fn.results(fn(torch.as_tensor(toks[:, i:i + 1]), torch.tensor(i)))
            ref, ref_cache = ref_step(ref_cache, jnp.asarray(toks[:, i:i + 1]), i)
            np.testing.assert_allclose(got.full_tensor().numpy(), np.asarray(ref),
                                       **DECODE_TOL, err_msg=f"step {i}")


# ---------------------------------------------------------------------------
# The rule, on real placements
# ---------------------------------------------------------------------------


def test_captures_on_names_one_card():
    cuda0, cuda1 = torch.device("cuda", 0), torch.device("cuda", 1)
    assert captures_on(cuda0, None)
    assert captures_on(cuda0, ["cuda:0", "cuda:0"])
    assert captures_on(cuda0, (cuda0, cuda0))
    assert not captures_on(cuda0, ["cuda:0", "cuda:1"])
    assert not captures_on(cuda1, ["cuda:0", "cuda:0"])
    assert not captures_on(torch.device("cpu"), None)
    assert not captures_on(torch.device("cpu"), ["cpu", "cpu"])


def test_the_rule_reads_the_mesh_and_the_cache_placements(mesh):
    """A ``gloo`` mesh is uncaptured; the heads-placed cache of
    ``init_cache`` captures and the dry-run's sequence-placed cache does
    not, whatever the mesh."""
    from repro_torch.launch.specs import cache_shardings

    cfg = get_config("smollm-135m").reduced()
    assert not tf.captures_mesh(mesh) and tf.captures_mesh(None)
    cuda = torch.device("cuda", 0)
    with use_sharding(mesh, production_rules()):
        heads = tf.init_cache(cfg, 2, 8, device="cpu")
        assert not tf.captures_decode(cfg, cuda, heads)  # a gloo mesh
    plain = tf.init_cache(cfg, 2, 8, device="cpu", place=False)
    by_sequence = distribute(plain, cache_shardings(cfg, plain, mesh, production_rules()))
    assert tf.sequence_placed(cfg, by_sequence) and not tf.sequence_placed(cfg, heads)
    assert not tf.sequence_placed(cfg, plain) and not tf.sequence_placed(cfg, None)
