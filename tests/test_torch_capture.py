"""What lets the port capture its forwards as CUDA graphs, checked on the
CPU: the readout's segment sum with static shapes (equal to the earlier
data-dependent formulation, copied here as its oracle, and within the
reference's readout tolerance), ``Program.run`` and the LM's
``decode_step`` free of host reads (run under ``FakeTensorMode``, which
refuses any data-dependent output), the decode position as a device
tensor (equal to the int position and to the reference), the capture
rule (a float32 MoE arch uncaptured), and the launch tally a capture
keeps.  The captures themselves run on the card
(``tests/test_torch_cuda.py``)."""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import (
    DataDependentOutputException,
    DynamicOutputShapeException,
    FakeTensorMode,
)

import repro.gnn as rgnn
import repro.models.transformer as ref_tf
import repro_torch
import repro_torch.models.transformer as tf
from hypothesis_compat import given, settings, st
from repro.models.stubs import make_inputs as ref_make_inputs
from repro_torch.api import CapturedForward
from repro_torch.configs import get_config
from repro_torch.gnn import GNNConfig
from repro_torch.gnn.layers import _segment_sum, segment_readout
from repro_torch.graphs import from_edges
from repro_torch.trace import add_launches, count_launch, launch_tally
from repro_torch.models import params_from_numpy
from repro_torch.tree import tree_map

READOUT_TOL = dict(rtol=2e-4, atol=2e-4)
DECODE_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_torch_lm_kinds.py's decode tolerance
XLSTM_REL_L2 = 1e-3  # the reference's mLSTM block tolerance (see test_torch_lm_kinds.py)
DECODE_ARCHS = ["smollm-135m", "recurrentgemma-2b", "xlstm-1.3b"]


def data_dependent_segment_sum(h, ids, valid, num_segments):
    """The segment sum as the port computed it before its shapes were made
    static (its tree as wide as the largest segment, read on the host)."""
    f = h.shape[1]
    rows = torch.nonzero(valid).flatten()
    seg = ids[rows]
    order = torch.sort(seg, stable=True).indices
    rows, seg = rows[order], seg[order]
    counts = torch.bincount(seg, minlength=num_segments)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(rows.numel(), device=h.device) - starts[seg]
    width = 1 << max(int(counts.max().item()) - 1, 0).bit_length() \
        if rows.numel() else 1
    tree = torch.zeros((num_segments, width, f), dtype=h.dtype, device=h.device)
    tree[seg, pos] = h[rows]
    while tree.shape[1] > 1:
        tree = tree[:, 0::2] + tree[:, 1::2]
    return tree[:, 0]


def oracle_readout(h, ids, num_segments, reduce):
    """``segment_readout`` with the data-dependent segment sum."""
    ids = ids.long()
    valid = (ids >= 0) & (ids < num_segments)
    if reduce == "max":
        return segment_readout(h, ids, num_segments, "max")
    s = data_dependent_segment_sum(h, ids, valid, num_segments)
    if reduce == "sum":
        return s
    counts = torch.zeros(num_segments, dtype=h.dtype)
    counts.index_add_(0, torch.where(valid, ids, 0), valid.to(h.dtype))
    return s / counts.clamp(min=1.0)[:, None]


def segments(seed, n, num_segments, layout):
    """Seeded rows and segment ids: ``sorted`` (a batch's layout: member
    graphs in order, then pad rows), ``shuffled`` (rows of a segment
    interleaved with others'), ``one`` (every valid row in one segment)
    and ``empty`` (no valid row)."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(n, 5)).astype(np.float32)
    if layout == "sorted":
        sizes = rng.integers(0, 2 * n // num_segments + 1, num_segments)
        ids = np.repeat(np.arange(num_segments), sizes)[:n]
        ids = np.concatenate([ids, np.full(n - len(ids), num_segments)])
    elif layout == "shuffled":
        ids = rng.integers(-1, num_segments + 2, n)
    elif layout == "one":
        ids = np.where(rng.random(n) < 0.7, num_segments - 1, num_segments)
    else:
        ids = np.full(n, num_segments)
    return torch.from_numpy(h), torch.from_numpy(ids.astype(np.int32))


CASES = [(seed, n, s, layout)
         for seed, (n, s) in enumerate([(40, 8), (37, 5), (64, 64), (1, 1), (130, 3)])
         for layout in ("sorted", "shuffled", "one", "empty")]


@pytest.mark.parametrize("seed,n,num_segments,layout", CASES)
def test_static_segment_sum_equals_the_data_dependent_one(seed, n, num_segments, layout):
    h, ids = segments(seed, n, num_segments, layout)
    ids = ids.long()
    valid = (ids >= 0) & (ids < num_segments)
    got = _segment_sum(h, ids, valid, num_segments)
    want = data_dependent_segment_sum(h, ids, valid, num_segments)
    assert got.shape == (num_segments, 5)
    assert torch.equal(got, want)


@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
@pytest.mark.parametrize("seed,n,num_segments,layout", CASES[::3])
def test_readouts_equal_the_oracle_and_the_reference(reduce, seed, n, num_segments, layout):
    h, ids = segments(seed, n, num_segments, layout)
    got = segment_readout(h, ids, num_segments, reduce)
    assert torch.equal(got, oracle_readout(h, ids, num_segments, reduce))
    ref = np.asarray(rgnn.segment_readout(jnp.asarray(h.numpy()), jnp.asarray(ids.numpy()),
                                          num_segments, reduce=reduce))
    np.testing.assert_allclose(got.numpy(), ref, **READOUT_TOL)
    empty = np.setdiff1d(np.arange(num_segments), ids.numpy())
    fill = -np.inf if reduce == "max" else 0.0
    assert np.all(got.numpy()[empty] == fill)


@settings(max_examples=60, deadline=None)
@given(n=st.integers(1, 80), num_segments=st.integers(1, 12), seed=st.integers(0, 2**31 - 1))
def test_static_segment_sum_property(n, num_segments, seed):
    h, ids = segments(seed, n, num_segments, "shuffled")
    ids = ids.long()
    valid = (ids >= 0) & (ids < num_segments)
    assert torch.equal(_segment_sum(h, ids, valid, num_segments),
                       data_dependent_segment_sum(h, ids, valid, num_segments))


def test_the_oracle_reads_the_host_and_the_static_sum_does_not():
    """``FakeTensorMode`` refuses a data-dependent output: the earlier
    formulation cannot run under it (so the checks below can fail), the
    static one can."""
    h, ids = segments(3, 40, 8, "sorted")
    ids = ids.long()
    with FakeTensorMode() as mode:
        fh, fids = mode.from_tensor(h), mode.from_tensor(ids)
        valid = (fids >= 0) & (fids < 8)
        assert _segment_sum(fh, fids, valid, 8).shape == (8, 5)
        with pytest.raises((DataDependentOutputException, DynamicOutputShapeException)):
            data_dependent_segment_sum(fh, fids, valid, 8)


# ---------------------------------------------------------------------------
# Program.run free of host reads
# ---------------------------------------------------------------------------


def small_batch():
    """A block-diagonal batch of three graphs (pad rows last) for GCN
    12 -> 8 -> 4."""
    rng = np.random.default_rng(7)
    g = from_edges(60, rng.integers(0, 60, 200), rng.integers(0, 60, 200))
    ids = np.repeat([0, 1, 2, 4], [20, 25, 9, 6]).astype(np.int32)
    x = rng.normal(size=(60, 12)).astype(np.float32)
    return g, torch.from_numpy(x), torch.from_numpy(ids)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("policy,order", [("sp_opt", "AC"), ("seq", "AC"), ("seq", "CA"),
                                          ("sp_generic", "CA")])
@pytest.mark.parametrize("readout", [None, "sum", "mean", "max"])
def test_program_run_reads_nothing_on_the_host(use_pallas, policy, order, readout):
    from repro_torch.core.schedule import ModelSchedule

    g, x, ids = small_batch()
    cfg = GNNConfig("gcn", f_in=12, hidden=8, n_classes=4, use_pallas=use_pallas)
    prog = repro_torch.compile(cfg, graph=g, device="cpu",
                               schedule=ModelSchedule.from_policies(policy, order, cfg.dims))
    params = prog.init(torch.Generator().manual_seed(0))
    kw = {} if readout is None else dict(segment_ids=ids, num_segments=4, readout=readout)
    want = prog.run(params, x, **kw)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake_params = tree_map(mode.from_tensor, params)
        fkw = dict(kw, segment_ids=mode.from_tensor(ids)) if readout else {}
        out = prog.run(fake_params, mode.from_tensor(x), **fkw)
        assert out.shape == want.shape and out.dtype == want.dtype


def test_build_captures_on_a_card_and_not_on_the_cpu_or_a_mesh():
    """A card captures, alone or as the two-stream pipeline's mesh of that
    card (``[cuda:0, cuda:0]``); a mesh of two cards, the CPU and a CPU
    mesh do not."""
    g, _, _ = small_batch()
    prog = repro_torch.compile(GNNConfig("gcn", 12, 8, 4, use_pallas=True), graph=g,
                               device="cpu")
    cuda = torch.device("cuda", 0)
    before = repro_torch.trace_count()
    on_card = prog._build(60, None, None, None, cuda)
    assert isinstance(on_card, CapturedForward) and on_card.graph is None
    assert callable(on_card.eager)
    two_streams = prog._build(60, ("cuda:0", "cuda:0"), None, None, cuda)
    assert isinstance(two_streams, CapturedForward) and two_streams.graph is None
    assert not isinstance(prog._build(60, ("cuda:0", "cuda:1"), None, None, cuda),
                          CapturedForward)
    assert not isinstance(prog._build(60, None, None, None, torch.device("cpu")),
                          CapturedForward)
    assert not isinstance(prog._build(60, ("cpu", "cpu"), None, None, torch.device("cpu")),
                          CapturedForward)
    assert repro_torch.trace_count() == before + 5  # one a build, as before


# ---------------------------------------------------------------------------
# decode_step with the position on the device
# ---------------------------------------------------------------------------


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def lm(arch, seed=5):
    cfg = get_config(arch).reduced()
    rp = ref_tf.init_params(cfg, jax.random.PRNGKey(seed))
    return cfg, rp, params_from_numpy(to_np(rp), "cpu")


def assert_logits_close(arch, ours, ref, msg=""):
    ours, ref = ours.numpy(), np.asarray(ref)
    if arch == "xlstm-1.3b":
        rel = np.linalg.norm(ours - ref) / np.linalg.norm(ref)
        assert rel <= XLSTM_REL_L2, (msg, rel)
    else:
        np.testing.assert_allclose(ours, ref, **DECODE_TOL, err_msg=msg)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_with_a_tensor_position_equals_the_int_and_the_reference(arch):
    """Ten steps with the position as a 0-d tensor: logits and every state
    of the cache ``torch.equal`` to the int position's, and the logits
    within the reference's decode tolerance of its ``decode_step``
    (recurrentgemma's local blocks at reduced width wrap their ring
    buffer: window 16 over 20 positions)."""
    cfg, rp, pt = lm(arch)
    if cfg.window:
        cfg = cfg.with_(window=16)
    steps = 20 if cfg.window else 10
    toks = np.array(ref_make_inputs(cfg, 2, steps, seed=6))
    by_int = tf.init_cache(cfg, 2, steps, device="cpu")
    by_tensor = tf.init_cache(cfg, 2, steps, device="cpu")
    ref_cache = ref_tf.init_cache(cfg, 2, steps)
    ref_step = jax.jit(lambda c, t, i: ref_tf.decode_step(cfg, rp, c, t, i))
    for i in range(steps):
        tok = torch.from_numpy(toks[:, i:i + 1])
        a, _ = tf.decode_step(cfg, pt, by_int, tok, i)
        b, _ = tf.decode_step(cfg, pt, by_tensor, tok, torch.tensor(i))
        assert torch.equal(a, b), f"step {i}"
        ref, ref_cache = ref_step(ref_cache, jnp.asarray(toks[:, i:i + 1]), i)
        assert_logits_close(arch, b, ref, f"step {i}")
    from repro_torch.tree import leaves

    assert all(torch.equal(x, y) for x, y in zip(leaves(by_int), leaves(by_tensor)))


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_step_reads_nothing_on_the_host(arch):
    cfg, _, pt = lm(arch)
    toks = torch.from_numpy(np.array(ref_make_inputs(cfg, 2, 1, seed=6)))
    tf.decode_step(cfg, pt, tf.init_cache(cfg, 2, 8, device="cpu"), toks, 0)  # real rope table
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        cache = tf.init_cache(cfg, 2, 8, device="cpu")
        logits, _ = tf.decode_step(cfg, tree_map(mode.from_tensor, pt), cache,
                                   mode.from_tensor(toks), mode.from_tensor(torch.tensor(3)))
        assert logits.shape == (2, 1, cfg.vocab)


def sequence_placed_cache(cfg):
    """A stand-in for the dry-run's cache: each KV state placed over its
    sequence (dim 2 of a stacked state), as ``launch.specs.cache_shardings``
    places it; the rule reads only the placements."""
    from types import SimpleNamespace

    from torch.distributed.tensor import Shard

    from repro_torch.models.attention import KVCache

    _, pat, rem = tf._layer_plan(cfg)
    kv = SimpleNamespace(placements=(Shard(1), Shard(2)))
    assert not rem
    return {"scanned": [KVCache(kv, kv) for _ in pat], "remainder": []}


def test_moe_archs_decode_uncaptured_by_the_rule():
    """The rule is static: every arch captures on a card, alone or on an
    NCCL mesh (device type ``cuda``), an MoE arch only in bf16 (the card's
    float32 grouped product reads its expert ends on the host, so a float32
    MoE arch decodes uncaptured); nothing captures on the CPU, where the
    decoder is ``decode_step`` itself, on a CPU (``gloo``) mesh, or over a
    cache placed over its sequence (whose decode reads the position on the
    host)."""
    from types import SimpleNamespace

    from repro_torch.models.sharding import use_sharding

    cuda = torch.device("cuda", 0)
    nccl, gloo = SimpleNamespace(device_type="cuda"), SimpleNamespace(device_type="cpu")
    assert tf.captures_decode(get_config("smollm-135m"), cuda)
    assert tf.captures_decode(get_config("recurrentgemma-2b"), cuda)
    assert tf.captures_decode(get_config("xlstm-1.3b"), cuda)
    for arch in ("granite-moe-1b-a400m", "granite-moe-3b-a800m"):
        assert tf.captures_decode(get_config(arch), cuda), arch
        assert not tf.captures_decode(get_config(arch).with_(dtype="float32"), cuda), arch
        assert not tf.captures_decode(get_config(arch), "cpu"), arch
        with use_sharding(nccl, None):
            assert tf.captures_decode(get_config(arch), cuda), arch
            assert not tf.captures_decode(get_config(arch).with_(dtype="float32"), cuda), arch
    assert not tf.captures_decode(get_config("smollm-135m"), "cpu")
    small = get_config("smollm-135m").reduced()
    with use_sharding(nccl, None):
        assert tf.captures_decode(small, cuda)
        assert tf.captures_decode(small, cuda, tf.init_cache(small, 2, 4, device="cpu"))
        assert not tf.captures_decode(small, cuda, sequence_placed_cache(small))
    with use_sharding(gloo, None):
        assert not tf.captures_decode(small, cuda)
    cfg, _, pt = lm("smollm-135m")
    cache = tf.init_cache(cfg, 2, 4, device="cpu")
    tok = torch.zeros((2, 1), dtype=torch.int32)
    step = tf.decoder(cfg, pt, cache, tok)
    want, _ = tf.decode_step(cfg, pt, tf.init_cache(cfg, 2, 4, device="cpu"), tok, 0)
    assert torch.equal(step(tok, 0), want)  # on the CPU: decode_step itself


# ---------------------------------------------------------------------------
# launch counts under capture
# ---------------------------------------------------------------------------


def fake_wrapper():
    def kernel():
        count_launch(kernel)

    kernel.launches = 0
    return kernel


def test_a_capture_tallies_its_launches_and_a_replay_adds_them():
    k = fake_wrapper()
    k()
    with launch_tally() as tally:
        k()
        k()
    assert k.launches == 1 and tally == {k: 2}
    add_launches(tally)
    add_launches(tally)
    assert k.launches == 5
    k()
    assert k.launches == 6


def test_a_tally_keeps_only_its_own_threads_launches():
    k = fake_wrapper()
    started, release = threading.Event(), threading.Event()

    def other():
        started.set()
        release.wait(10)
        for _ in range(3):
            k()

    t = threading.Thread(target=other)
    t.start()
    started.wait(10)
    with launch_tally() as tally:
        release.set()
        t.join(10)
        k()
    assert tally == {k: 1} and k.launches == 3
