"""What lets the port capture its training steps as CUDA graphs, checked on
the CPU: ``Program.train_step`` and ``launch.train``'s AdamW step free of
host reads (run under ``FakeTensorMode``, which refuses a data-dependent
output), the aggregation's backward with its segment sum unchecked, its
weight-0 slots spread over the rows, and equal to the earlier formulation
(kept in ``aggregate_oracle.py`` as its oracle), the state
written in place with the bits of the fresh-tensor step, the shape key's
builds equal to the reference's retraces, the rule that keeps a CPU
(``gloo``) mesh and a float32 MoE arch uncaptured, and what the runner does with a step that failed
after writing its state.  The captures themselves run on the card
(``tests/test_torch_cuda.py``)."""
import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

import repro
import repro_torch
from aggregate_oracle import backward_before, band, cora_band
from hypothesis_compat import given, settings, st
from repro.core.cost_model import GNNLayerWorkload as RefWorkload
from repro.core.schedule import ModelSchedule as RefSchedule
from repro.gnn.layers import aggregate_band as ref_aggregate_band
from repro.gnn.model import make_node_classification_task as ref_task
from repro.graphs import from_edges as ref_from_edges
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.core.cost_model import GNNLayerWorkload
from repro_torch.core.schedule import ModelSchedule
from repro_torch.data import LMDataPipeline
from repro_torch.gnn import make_node_classification_task, params_from_numpy
from repro_torch.gnn.layers import aggregate_band
from repro_torch.graphs import from_edges
from repro_torch.kernels.common import CudaKernelError
from repro_torch.launch import train
from repro_torch.models import init_params
from repro_torch.models.sharding import use_sharding
from repro_torch.models.transformer import captures_train
from repro_torch.optim import init_error_feedback
from repro_torch.tree import leaves, tree_map

DIMS = [(12, 16), (16, 4)]
#: every eager dataflow that trains (``pp`` without a mesh is SP-Generic's
#: band loop; the kernel tier's layers are refused before a build)
DATAFLOWS = [(p, o) for p in ("seq", "sp_generic", "sp_opt", "pp") for o in ("AC", "CA")]
LM_ARCHS = ["smollm-135m", "recurrentgemma-2b", "xlstm-1.3b"]


# ---------------------------------------------------------------------------
# _AggregateBand.backward: no host read, the same bits
# ---------------------------------------------------------------------------


def grads_now(idx, wts, x, g):
    w, xs = wts.clone().requires_grad_(), x.clone().requires_grad_()
    return torch.autograd.grad(aggregate_band(idx, w, xs), (w, xs), g)


def assert_backward_equals_the_oracle(seed, b, d, v, f, make=band):
    idx, wts, x, g = make(seed, b, d, v, f)
    gw, gx = grads_now(idx, wts, x, g)
    want_w, want_x = backward_before(idx, wts, x, g)
    assert torch.equal(gw, want_w) and torch.equal(gx, want_x)


#: bands of every degree (:func:`band`), and one band of the cora training
#: cell's layer 1, most of its slots padding (:func:`cora_band`)
ORACLE_BANDS = [
    pytest.param(band, s, b, d, v, f, id=f"{s}-{b}-{d}-{v}-{f}") for s, b, d, v, f in [
        (0, 1, 1, 1, 1), (1, 8, 3, 5, 4), (2, 40, 7, 33, 16), (3, 128, 16, 64, 8),
        (4, 17, 32, 200, 3), (5, 64, 1, 64, 12), (6, 300, 9, 2, 5)]
] + [pytest.param(cora_band, 7, 128, 82, 2816, 16, id="cora")]


@pytest.mark.parametrize("make,seed,b,d,v,f", ORACLE_BANDS)
def test_aggregate_backward_equals_the_earlier_formulation(make, seed, b, d, v, f):
    assert_backward_equals_the_oracle(seed, b, d, v, f, make)


@settings(max_examples=60, deadline=None)
@given(b=st.integers(1, 64), d=st.integers(1, 24), v=st.integers(1, 80),
       f=st.integers(1, 20), seed=st.integers(0, 2**31 - 1))
def test_aggregate_backward_property(b, d, v, f, seed):
    assert_backward_equals_the_oracle(seed, b, d, v, f)


class SegmentSums(TorchDispatchMode):
    """Records the ``unsafe`` flag and the ``lengths`` of every
    ``segment_reduce`` and every op that reads a tensor on the host."""

    def __init__(self):
        super().__init__()
        self.unsafe, self.lengths, self.host_reads = [], [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.ops.aten.segment_reduce.default:
            names = [a.name for a in func._schema.arguments]
            at = names.index("unsafe")
            self.unsafe.append(kwargs.get("unsafe", args[at] if len(args) > at else False))
            at = names.index("lengths")
            self.lengths.append(kwargs.get("lengths", args[at] if len(args) > at else None))
        if func in (torch.ops.aten._local_scalar_dense.default, torch.ops.aten.nonzero.default):
            self.host_reads.append(func)
        return func(*args, **kwargs)


def test_aggregate_backward_runs_its_segment_sum_unchecked():
    """The checks ``segment_reduce`` skips when ``unsafe`` are host reads
    inside its kernel, which neither ``FakeTensorMode`` nor a dispatch mode
    sees; so the backward must call it unchecked (the oracle does not),
    and read nothing else on the host."""
    idx, wts, x, g = band(3, 40, 7, 33, 16)
    with SegmentSums() as mode:
        grads_now(idx, wts, x, g)
    assert mode.unsafe == [True] and not mode.host_reads
    with SegmentSums() as mode:
        backward_before(idx, wts, x, g)
    assert mode.unsafe == [False]
    with FakeTensorMode(allow_non_fake_inputs=True) as fake:
        gw, gx = grads_now(*(fake.from_tensor(t) for t in (idx, wts, x, g)))
        assert gw.shape == wts.shape and gx.shape == x.shape


@pytest.mark.parametrize("make,seed,b,d,v,f", ORACLE_BANDS)
def test_aggregate_backward_spreads_zero_weight_slots(make, seed, b, d, v, f):
    """Slots of weight zero (the padding, which points at row 0) are keyed
    by their position, not their index: no row's segment holds more than
    its real in-degree and ⌈B·D / rows⌉ of them.  Keyed by index, row 0's
    segment would hold every padded slot of the band."""
    idx, wts, x, g = make(seed, b, d, v, f)
    with SegmentSums() as mode:
        grads_now(idx, wts, x, g)
    (lengths,) = mode.lengths
    real = torch.zeros(v, dtype=torch.int64)
    real.scatter_add_(0, idx.reshape(-1).long(), (wts.reshape(-1) != 0).long())
    assert int(lengths.sum()) == b * d
    assert bool((lengths <= real + -(-b * d // v)).all())


def test_a_nan_gradient_at_a_padded_slot_lands_where_the_slot_is_keyed():
    """A difference by design from the reference: where ``g`` is NaN in a
    row with padded slots, ``0 * NaN`` puts NaN on row 0 in the reference's
    scatter, and on the rows the padded slots are keyed to (their flat
    position modulo the rows) in the port.  Real slots put it on their
    index in both; every other entry agrees."""
    idx, wts, x, g = cora_band(7, b=6, d=5, v=11, f=3)
    idx[2], wts[2] = torch.tensor([4, 9, 0, 0, 0]), torch.tensor([0.5, 0.25, 0, 0, 0])
    g[2, 1] = float("nan")
    _, gx = grads_now(idx, wts, x, g)
    _, ref = jax.vjp(lambda a: ref_aggregate_band(idx.numpy(), wts.numpy(), a), x.numpy())
    want = torch.from_numpy(np.array(ref(g.numpy())[0]))
    def nan_rows(t):
        return set(torch.isnan(t[:, 1]).nonzero().flatten().tolist())

    assert nan_rows(want) == {0, 4, 9}
    assert nan_rows(gx) == {4, 9} | {(2 * 5 + j) % 11 for j in (2, 3, 4)}
    assert not torch.isnan(gx[:, [0, 2]]).any()
    torch.testing.assert_close(gx[:, [0, 2]], want[:, [0, 2]], rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# Program.train_step: no host read, one build per shape key
# ---------------------------------------------------------------------------


def ring(v):
    src = np.arange(v)
    return (v, np.concatenate([src, (src + 1) % v, src]),
            np.concatenate([(src + 1) % v, src, (src * 7) % v]))


@pytest.mark.parametrize("policy,order", DATAFLOWS)
@pytest.mark.parametrize("kind", ["gcn", "sage", "gin"])
def test_gnn_train_step_reads_nothing_on_the_host(kind, policy, order):
    g = from_edges(*ring(40))
    prog = repro_torch.compile(
        [GNNLayerWorkload(g.nnz, fi, fo) for fi, fo in DIMS], graph=g, kind=kind,
        device="cpu", schedule=ModelSchedule.from_policies(policy, order, DIMS, band_size=16))
    params = prog.init(torch.Generator().manual_seed(0))
    task = make_node_classification_task(g, 12, 4, device="cpu")
    with SegmentSums() as mode:
        want_loss, want = prog.train_step(params, *task)
    assert mode.unsafe and all(mode.unsafe) and not mode.host_reads
    with FakeTensorMode(allow_non_fake_inputs=True) as fake:
        loss, new = prog.train_step(tree_map(fake.from_tensor, params),
                                    *(fake.from_tensor(t) for t in task))
        assert loss.shape == want_loss.shape
        assert [{k: v.shape for k, v in layer.items()} for layer in new] == \
            [{k: v.shape for k, v in layer.items()} for layer in want]


def train_sequence(compile_, from_edges_, task_, init, count):
    """Builds counted by each of five ``train_step`` calls: one shape, the
    same shape again, a graph with another node count, another lr, another
    feature width (the first layer's parameters and the features)."""
    deltas = []

    def step(prog, params, task, lr=0.05):
        before = count()
        prog.train_step(params, *task, lr=lr)
        deltas.append(count() - before)

    def program(v, f_in):
        g = from_edges_(*ring(v))
        return g, compile_([(f_in, 16), (16, 4)], g)

    g, prog = program(40, 12)
    params = init(prog)
    step(prog, params, task_(g, 12))
    step(prog, params, task_(g, 12))
    g48, prog48 = program(48, 12)
    step(prog48, params, task_(g48, 12))
    step(prog, params, task_(g, 12), lr=0.01)
    _, prog20 = program(40, 20)
    step(prog, init(prog20), task_(g, 20))
    return deltas


def test_train_step_builds_where_the_reference_retraces():
    ref = train_sequence(
        lambda dims, g: repro.compile(
            [RefWorkload(g.nnz, fi, fo) for fi, fo in dims], graph=g,
            schedule=RefSchedule.from_policies("sp_opt", "AC", dims, band_size=16)),
        ref_from_edges, lambda g, f: ref_task(g, f, 4, seed=0),
        lambda prog: prog.init(jax.random.PRNGKey(0)), repro.trace_count)
    port = train_sequence(
        lambda dims, g: repro_torch.compile(
            [GNNLayerWorkload(g.nnz, fi, fo) for fi, fo in dims], graph=g, device="cpu",
            schedule=ModelSchedule.from_policies("sp_opt", "AC", dims, band_size=16)),
        from_edges, lambda g, f: make_node_classification_task(g, f, 4, seed=0, device="cpu"),
        lambda prog: params_from_numpy(
            jax.tree_util.tree_map(np.asarray, prog.init(torch.Generator().manual_seed(0))),
            device="cpu"),
        repro_torch.trace_count)
    assert ref == [1, 0, 1, 1, 1]
    assert port == ref


# ---------------------------------------------------------------------------
# launch.train's step: no host read, the state written in place, the rule
# ---------------------------------------------------------------------------


def lm_state(arch, compression, seed=0):
    cfg = get_config(arch).reduced()
    init_opt, step = train.build_trainer(cfg, lr=1e-3, total_steps=10,
                                         grad_compression=compression)
    params = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    ef = init_error_feedback(params) if compression else None
    data = LMDataPipeline(cfg, 2, 8, seed=seed, device="cpu")
    return cfg, step, (params, init_opt(params), ef), data


@pytest.mark.parametrize("compression", [None, "int8"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_train_step_reads_nothing_on_the_host(arch, compression):
    """The step a capture records (its state written in place) under
    ``FakeTensorMode``."""
    _, step, state, data = lm_state(arch, compression)
    step.eager(*state, data.peek(0))  # the tables the model caches made real
    with FakeTensorMode(allow_non_fake_inputs=True) as fake:
        p, o, e = tree_map(fake.from_tensor, state)
        out = step._step(p, o, e, tree_map(fake.from_tensor, data.peek(0)), True)
        assert out[0].shape == ()
        assert [t.shape for t in leaves(out[1:])] == [t.shape for t in leaves(state)]


@pytest.mark.parametrize("compression", [None, "int8"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_state_written_in_place_equals_the_fresh_step(arch, compression):
    """Three steps that write params, moments, step counter and residual
    into the state they are given (what the captured graph does) against
    three of the uncaptured step: the same bits, and the same tensors
    returned as were given."""
    _, step, state, data = lm_state(arch, compression)
    fresh = state
    owned = tree_map(torch.clone, state)
    for s in range(3):
        batch = data.peek(s)
        loss_f, *fresh = step.eager(*fresh, batch)
        loss_o, *out = step._step(*owned, batch, True)
        assert all(a is b for a, b in zip(leaves(out), leaves(owned)))
        assert torch.equal(loss_f, loss_o), s
    assert int(owned[1].step) == 3
    for a, b in zip(leaves(fresh), leaves(owned)):
        assert torch.equal(a, b)
    assert not all(torch.equal(a, b) for a, b in zip(leaves(state[0]), leaves(owned[0])))


def test_lm_trainer_is_uncaptured_on_the_cpu():
    """On the CPU the step is the uncaptured one: it builds no graph and
    leaves the state it was given untouched."""
    _, step, state, data = lm_state("smollm-135m", "int8")
    kept = tree_map(torch.clone, state)
    loss, *new = step(*state, data.peek(0))
    assert not step.graphs
    assert all(torch.equal(a, b) for a, b in zip(leaves(state), leaves(kept)))
    want_loss, *want = step.eager(*kept, data.peek(0))
    assert torch.equal(loss, want_loss)
    assert all(torch.equal(a, b) for a, b in zip(leaves(new), leaves(want)))


def test_training_captures_by_a_static_rule():
    """A card captures, alone or on an NCCL mesh (device type ``cuda``);
    the CPU, a CPU (``gloo``) mesh, a mesh of no device type and a float32
    MoE arch do not."""
    from types import SimpleNamespace

    cuda = torch.device("cuda", 0)
    nccl, gloo = SimpleNamespace(device_type="cuda"), SimpleNamespace(device_type="cpu")
    for arch in LM_ARCHS + ["tinyllama-1.1b", "olmo-1b"]:
        assert captures_train(get_config(arch), cuda), arch
        assert not captures_train(get_config(arch), "cpu"), arch
        assert captures_train(get_config(arch), cuda, mesh=nccl), arch
        assert not captures_train(get_config(arch), cuda, mesh=gloo), arch
        assert not captures_train(get_config(arch), cuda, mesh=object()), arch
        assert not captures_train(get_config(arch), "cpu", mesh=nccl), arch
        with use_sharding(nccl, None):
            assert captures_train(get_config(arch), cuda), arch
        with use_sharding(gloo, None):
            assert not captures_train(get_config(arch), cuda), arch
    for arch in ("granite-moe-1b-a400m", "granite-moe-3b-a800m"):
        assert captures_train(get_config(arch), cuda), arch
        assert not captures_train(get_config(arch).with_(dtype="float32"), cuda), arch
        assert captures_train(get_config(arch), cuda, mesh=nccl), arch
        assert not captures_train(get_config(arch).with_(dtype="float32"), cuda,
                                  mesh=nccl), arch
        assert not captures_train(get_config(arch), cuda, mesh=gloo), arch


def test_a_step_that_failed_after_writing_its_state_is_not_rerun(tmp_path, monkeypatch):
    """A captured step whose replay fails may leave its state half written
    (the graph owns it).  Here the fifth step writes its new state into its
    arguments, as a replay does, then raises ``CudaKernelError``: the
    runner re-raises it at once, with no retry that would start from the
    written state; ``launch.train`` run again with the same flags resumes
    from its latest checkpoint and ends bit for bit where a straight run
    ends."""
    flags = ["--reduced", "--device", "cpu", "--batch", "2", "--seq", "16",
             "--checkpoint-every", "2", "--steps", "6"]
    calls = []
    real = train.TrainStep.__call__

    def failing(self, params, opt, ef, batch):
        calls.append(int(opt.step))
        if len(calls) == 5:
            self._step(params, opt, ef, batch, True)
            raise CudaKernelError("CUDA graph replay failed: injected")
        return real(self, params, opt, ef, batch)

    monkeypatch.setattr(train.TrainStep, "__call__", failing)
    with pytest.raises(CudaKernelError, match="injected"):
        train.main(flags + ["--checkpoint-dir", str(tmp_path / "a")])
    assert calls == [0, 1, 2, 3, 4]
    monkeypatch.undo()
    assert Checkpointer(tmp_path / "a").latest_step() == 4
    assert train.main(flags + ["--checkpoint-dir", str(tmp_path / "a")]) == 0
    assert train.main(flags + ["--checkpoint-dir", str(tmp_path / "b")]) == 0
    cfg = get_config("smollm-135m").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    init_opt, _ = train.build_trainer(cfg)
    like = {"params": params, "opt": init_opt(params), "data": {"seed": 0, "step": 0}}
    a, b = (Checkpointer(tmp_path / d).restore(like, step=6) for d in ("a", "b"))
    assert all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))
