"""What lets the port capture an MoE arch's decode and training steps as
CUDA graphs, checked on the CPU: ``moe_ragged``'s grouped expert product
over device offsets (``moe._grouped_product``) against the reference's
``ragged_dot`` path (forward and gradients at the reference's MoE
tolerance, ``tests/test_models.py``'s 1e-4 / 1e-5) and ``torch.equal`` to
the per-expert loop it replaced (``moe._grouped_product_plain``, kept as
its plain version), with empty experts and with one expert taking every
pair; reduced granite-moe's ``decode_step`` and ``lm_loss`` with its
gradients in bf16 (the dtype captured) under ``FakeTensorMode`` (which
refuses a data-dependent output) and with no host-read op dispatched;
and ``launch.train``'s step with the state written in place equal to the
fresh step.  The captures themselves, and the card's bf16 route under
``set_sync_debug_mode``, run on the card (``tests/test_torch_cuda.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import repro.models.moe as ref_moe
import repro_torch.models.moe as moe
import repro_torch.models.transformer as tf
from repro.models.stubs import make_inputs as ref_make_inputs
from repro_torch.configs import get_config
from repro_torch.data import LMDataPipeline
from repro_torch.launch import train
from repro_torch.models import ArchConfig, MoEConfig, init_params, lm_loss, params_from_numpy
from repro_torch.optim import init_error_feedback
from repro_torch.tree import leaves, tree_map
from test_torch_train_capture import SegmentSums

MOE_TOL = dict(rtol=1e-4, atol=1e-5)
ARCH = "granite-moe-1b-a400m"


def moe_cfg(e=4, k=2, d=16, ff=32, dtype="float32"):
    return ArchConfig(name="m", family="moe", n_layers=2, d_model=d, n_heads=2,
                      n_kv_heads=2, d_ff=ff, vocab=64, block_pattern=("moe",),
                      moe=MoEConfig(n_experts=e, top_k=k), dtype=dtype)


def rand(shape, seed, scale=1.0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32) * scale


def both(cfg, seed):
    """The reference's MoE weights as numpy (for the reference) and as
    tensors (for the port)."""
    p = jax.tree_util.tree_map(np.asarray, ref_moe.init_moe(cfg, jax.random.PRNGKey(seed)))
    return jax.tree_util.tree_map(jnp.asarray, p), params_from_numpy(p, "cpu")


def close(ours, ref, msg=""):
    np.testing.assert_allclose(ours.detach().float().numpy(), np.asarray(ref), **MOE_TOL,
                               err_msg=msg)


# ---------------------------------------------------------------------------
# moe_ragged against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("e,k,tokens,seed", [(4, 2, (2, 8), 0), (8, 2, (1, 3), 1),
                                             (8, 3, (2, 16), 2), (16, 4, (3, 5), 3)])
def test_grouped_moe_matches_the_reference(e, k, tokens, seed):
    """Forward, aux loss, and the gradients of the input and of every
    weight against the reference's ``moe_ragged`` (``lax.ragged_dot``)
    and ``jax.grad``; few tokens over many experts leave some empty."""
    cfg = moe_cfg(e, k)
    rp, pt = both(cfg, seed)
    x = rand((*tokens, 16), seed + 10, 0.3)

    def ref_loss(p, x):
        out, aux = ref_moe.moe_ragged(cfg, p, x)
        return jnp.sum(out**2) + aux

    ref_out, ref_aux = ref_moe.moe_ragged(cfg, rp, jnp.asarray(x))
    ref_g = jax.grad(ref_loss, argnums=(0, 1))(rp, jnp.asarray(x))
    pg = {n: t.clone().requires_grad_() for n, t in pt.items()}
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = moe.moe_ragged(cfg, pg, xt)
    close(out, ref_out)
    np.testing.assert_allclose(float(aux.detach()), float(ref_aux), rtol=1e-5)
    (out.square().sum() + aux).backward()
    close(xt.grad, ref_g[1], "x")
    for n in pg:
        close(pg[n].grad, ref_g[0][n], n)


# ---------------------------------------------------------------------------
# the grouped product against the per-expert loop it replaced
# ---------------------------------------------------------------------------


def grads_of(fn, cfg, xs, ends, ws, gy):
    args = [t.clone().requires_grad_() for t in [xs, *ws]]
    y = fn(cfg, args[0], ends, *args[1:])
    y.backward(gy)
    return [y.detach()] + [a.grad for a in args]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("counts", [
    [3, 0, 5, 2],         # an empty expert inside
    [0, 0, 7, 0],         # one expert takes every row
    [4, 1, 0, 0, 2, 0],   # trailing empty experts
    [0, 6, 6, 0, 1, 9],   # leading empty expert
    [1, 1, 1, 1],
])
def test_grouped_product_equals_the_per_expert_loop(counts, dtype):
    """``_grouped_product`` over device segment ends ``torch.equal`` to one
    matmul per expert over the same rows: the output and the gradients of
    the rows and of the three weights (an empty expert's gradient is
    zero)."""
    cfg = moe_cfg(len(counts), 2, 16, 32)
    e, d, ff = len(counts), 16, 32
    g = torch.Generator().manual_seed(sum(counts))
    ends = torch.cumsum(torch.tensor(counts), 0).to(torch.int32)
    n = int(ends[-1])
    xs = torch.randn((n, d), generator=g).to(dtype)
    ws = [(torch.randn(s, generator=g) * 0.2).to(dtype) for s in ((e, d, ff), (e, d, ff),
                                                                  (e, ff, d))]
    gy = torch.randn((n, d), generator=g).to(dtype)
    got = grads_of(moe._grouped_product, cfg, xs, ends, ws, gy)
    want = grads_of(moe._grouped_product_plain, cfg, xs, ends, ws, gy)
    for name, a, b in zip(["out", "rows", "gate", "up", "down"], got, want):
        assert torch.equal(a, b), name
    empty = [j for j, c in enumerate(counts) if c == 0]
    assert all(bool((w[empty] == 0).all()) for w in got[2:])


def moe_ragged_twice(cfg, p, x, monkeypatch):
    """``moe_ragged`` with the grouped product, then with the per-expert
    loop in its place: each run's output, aux and gradients."""
    runs = []
    for fn in (moe._grouped_product, moe._grouped_product_plain):
        monkeypatch.setattr(moe, "_grouped_product", fn)
        pg = {n: t.clone().requires_grad_() for n, t in p.items()}
        xg = x.clone().requires_grad_()
        out, aux = moe.moe_ragged(cfg, pg, xg)
        (out.float().square().sum() + aux).backward()
        runs.append([out.detach(), aux.detach(), xg.grad] + [pg[n].grad for n in sorted(pg)])
    return runs


@pytest.mark.parametrize("e,k,tokens,seed", [(8, 2, (1, 2), 0), (4, 2, (2, 8), 1),
                                             (32, 8, (2, 3), 2)])
def test_moe_ragged_equals_the_per_expert_loop(e, k, tokens, seed, monkeypatch):
    """The whole layer, route to combine, ``torch.equal`` to the same layer
    run with the per-expert loop, forward and backward; decode-sized
    batches leave most experts empty (2 tokens x top 2 over 8 experts)."""
    cfg = moe_cfg(e, k)
    _, p = both(cfg, seed)
    x = torch.from_numpy(rand((*tokens, 16), seed + 20, 0.3))
    got, want = moe_ragged_twice(cfg, p, x, monkeypatch)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_moe_ragged_with_one_expert_taking_every_pair(monkeypatch):
    """top 1 with a router that sends every token to expert 2 (positive
    inputs, only that column non-zero): one segment holds every pair, the
    other three are empty; equal to the per-expert loop, and every other
    expert's gradient is zero."""
    cfg = moe_cfg(4, 1)
    _, p = both(cfg, 4)
    router = torch.zeros_like(p["router"])
    router[:, 2] = 1.0
    p = dict(p, router=router)
    x = torch.from_numpy(np.abs(rand((2, 6, 16), 5, 0.3)) + 0.01)
    got, want = moe_ragged_twice(cfg, p, x, monkeypatch)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for g in got[3:6]:  # experts_down, experts_gate, experts_up
        assert bool((g[[0, 1, 3]] == 0).all()) and bool((g[2] != 0).any())


# ---------------------------------------------------------------------------
# no host read: what lets a CUDA graph hold the MoE
# ---------------------------------------------------------------------------


def granite(dtype="bfloat16"):
    """Reduced granite-moe, in bf16 by default: the dtype whose steps are
    captured (the meta kernel of ``_grouped_mm``, which ``FakeTensorMode``
    runs, takes bf16 alone, as the card's device-offset route does)."""
    cfg = get_config(ARCH).reduced(dtype=dtype)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, params


def moe_state(compression, dtype):
    cfg, params = granite(dtype)
    init_opt, step = train.build_trainer(cfg, lr=1e-3, total_steps=10,
                                         grad_compression=compression)
    ef = init_error_feedback(params) if compression else None
    data = LMDataPipeline(cfg, 2, 8, seed=0, device="cpu")
    return step, (params, init_opt(params), ef), data


@pytest.mark.parametrize("batch", [1, 2])
def test_moe_decode_step_reads_nothing_on_the_host(batch):
    cfg, params = granite()
    toks = torch.from_numpy(np.array(ref_make_inputs(cfg, batch, 1, seed=6)))
    with SegmentSums() as mode:
        want, _ = tf.decode_step(cfg, params, tf.init_cache(cfg, batch, 8, device="cpu"), toks,
                                 torch.tensor(0))
    assert not mode.host_reads
    with FakeTensorMode(allow_non_fake_inputs=True) as fake:
        logits, _ = tf.decode_step(cfg, tree_map(fake.from_tensor, params),
                                   tf.init_cache(cfg, batch, 8, device="cpu"),
                                   fake.from_tensor(toks), fake.from_tensor(torch.tensor(3)))
        assert logits.shape == want.shape == (batch, 1, cfg.vocab)


@pytest.mark.parametrize("seq", [1, 8])
def test_moe_loss_and_gradients_read_nothing_on_the_host(seq):
    """``lm_loss`` (the router's aux loss in it) and ``autograd.grad`` of
    every parameter, as the training step runs them."""
    cfg, params = granite()
    inputs = torch.from_numpy(np.array(ref_make_inputs(cfg, 2, seq, seed=7)))
    batch = {"inputs": inputs, "labels": torch.roll(inputs, -1, dims=1)}

    def loss_and_grads(p, b):
        p = tree_map(lambda t: t.detach().requires_grad_(), p)
        loss = lm_loss(cfg, p, b)
        return loss, torch.autograd.grad(loss, leaves(p))

    with SegmentSums() as mode:
        want_loss, want = loss_and_grads(params, batch)
    assert not mode.host_reads
    with FakeTensorMode(allow_non_fake_inputs=True) as fake:
        loss, grads = loss_and_grads(tree_map(fake.from_tensor, params),
                                     tree_map(fake.from_tensor, batch))
        assert loss.shape == want_loss.shape == ()
        assert [g.shape for g in grads] == [g.shape for g in want]


@pytest.mark.parametrize("compression", [None, "int8"])
def test_moe_train_step_reads_nothing_on_the_host(compression):
    """The step a capture records (its state written in place) under
    ``FakeTensorMode``."""
    step, state, data = moe_state(compression, "bfloat16")
    step.eager(*state, data.peek(0))
    with FakeTensorMode(allow_non_fake_inputs=True) as fake:
        p, o, e = tree_map(fake.from_tensor, state)
        out = step._step(p, o, e, tree_map(fake.from_tensor, data.peek(0)), True)
        assert out[0].shape == ()
        assert [t.shape for t in leaves(out[1:])] == [t.shape for t in leaves(state)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("compression", [None, "int8"])
def test_moe_state_written_in_place_equals_the_fresh_step(compression, dtype):
    """Three steps that write params, moments, step counter and residual
    into the state they are given (what the captured graph does) against
    three of the uncaptured step: the same bits."""
    step, state, data = moe_state(compression, dtype)
    fresh, owned = state, tree_map(torch.clone, state)
    for s in range(3):
        loss_f, *fresh = step.eager(*fresh, data.peek(s))
        loss_o, *out = step._step(*owned, data.peek(s), True)
        assert all(a is b for a, b in zip(leaves(out), leaves(owned)))
        assert torch.equal(loss_f, loss_o), s
    assert int(owned[1].step) == 3
    assert all(torch.equal(a, b) for a, b in zip(leaves(fresh), leaves(owned)))
    assert not all(torch.equal(a, b) for a, b in zip(leaves(state[0]), leaves(owned[0])))
