"""Parity of the port's MoE, RG-LRU and xLSTM blocks, and of the three
model families built from them, with the reference's, on the CPU.

Inputs come from numpy with a seed, and weights are the reference's own
init carried across with ``params_from_numpy``.  Module tolerances are
those of ``tests/test_models.py``: MoE 1e-4 / 1e-5 (aux 1e-5 relative),
RG-LRU 2e-4 / 2e-5, mLSTM 1e-3 / 1e-4.  Whole-model tolerances are stated
beside each test.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.analytic as ref_analytic
import repro.launch.serve as ref_serve
import repro.models.moe as ref_moe
import repro.models.rglru as ref_rglru
import repro.models.transformer as ref_tf
import repro.models.xlstm as ref_xlstm
import repro_torch.launch.analytic as analytic
import repro_torch.launch.serve as serve
import repro_torch.models.moe as moe
import repro_torch.models.rglru as rglru
import repro_torch.models.transformer as tf
import repro_torch.models.xlstm as xlstm
from repro.configs import get_config as ref_get_config
from repro.configs.shapes import SHAPES as REF_SHAPES
from repro.models.stubs import make_inputs as ref_make_inputs
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.models import ArchConfig, MoEConfig, make_inputs, params_from_numpy
from repro_torch.tree import leaves as tree_leaves

MOE_TOL = dict(rtol=1e-4, atol=1e-5)
RGLRU_TOL = dict(rtol=2e-4, atol=2e-5)
MLSTM_TOL = dict(rtol=1e-3, atol=1e-4)
ARCHS = ["granite-moe-1b-a400m", "recurrentgemma-2b", "xlstm-1.3b"]

MOE_CFG = ArchConfig(
    name="m", family="moe", n_layers=2, d_model=16, n_heads=2, n_kv_heads=2,
    d_ff=32, vocab=64, block_pattern=("moe",), moe=MoEConfig(n_experts=4, top_k=2),
)
RGLRU_CFG = ArchConfig(
    name="r", family="hybrid", n_layers=3, d_model=24, n_heads=2, n_kv_heads=1,
    d_ff=48, vocab=64, block_pattern=("rglru", "rglru", "local"), d_rnn=24,
)
XLSTM_CFG = ArchConfig(
    name="x", family="ssm", n_layers=8, d_model=16, n_heads=2, n_kv_heads=2,
    d_ff=0, vocab=64, block_pattern=("mlstm",) * 7 + ("slstm",),
)


def rand(shape, seed, scale=1.0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32) * scale


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def both(init_ref, cfg, seed):
    """The reference's init as numpy (for the reference) and as tensors."""
    p = to_np(init_ref(cfg, jax.random.PRNGKey(seed)))
    return jax.tree_util.tree_map(jnp.asarray, p), params_from_numpy(p, "cpu")


def close(ours, ref, tol, msg=""):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), **tol, err_msg=msg)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", ["dense", "ragged"])
def test_moe_paths_match_reference(path):
    rp, pt = both(ref_moe.init_moe, MOE_CFG, 0)
    x = rand((2, 8, 16), 1, 0.3)
    ref_out, ref_aux = getattr(ref_moe, f"moe_{path}")(MOE_CFG, rp, jnp.asarray(x))
    out, aux = getattr(moe, f"moe_{path}")(MOE_CFG, pt, torch.from_numpy(x))
    close(out, ref_out, MOE_TOL)
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=1e-5)


def test_moe_ragged_matches_dense():
    _, pt = both(ref_moe.init_moe, MOE_CFG, 2)
    x = torch.from_numpy(rand((2, 8, 16), 3, 0.3))
    d_out, d_aux = moe.moe_dense(MOE_CFG, pt, x)
    r_out, r_aux = moe.moe_ragged(MOE_CFG, pt, x)
    torch.testing.assert_close(r_out, d_out, **MOE_TOL)
    assert abs(float(d_aux) - float(r_aux)) <= 1e-5 * abs(float(d_aux))


def test_moe_aux_loss_uniform_router_is_the_weight():
    """Switch aux loss == aux_weight when routing is perfectly uniform."""
    rp, pt = both(ref_moe.init_moe, MOE_CFG, 0)
    rp = dict(rp, router=jnp.zeros_like(rp["router"]))
    pt = dict(pt, router=torch.zeros_like(pt["router"]))
    x = rand((1, 64, 16), 4)
    _, aux = moe.moe_dense(MOE_CFG, pt, torch.from_numpy(x))
    _, ref_aux = ref_moe.moe_dense(MOE_CFG, rp, jnp.asarray(x))
    np.testing.assert_allclose(float(aux), MOE_CFG.moe.router_aux_weight, rtol=1e-3)
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=1e-5)


def test_moe_ffn_auto_is_ragged():
    _, pt = both(ref_moe.init_moe, MOE_CFG, 5)
    x = torch.from_numpy(rand((2, 6, 16), 6, 0.3))
    out, aux = moe.moe_ffn(MOE_CFG, pt, x)
    r_out, r_aux = moe.moe_ragged(MOE_CFG, pt, x)
    assert torch.equal(out, r_out) and torch.equal(aux, r_aux)
    with pytest.raises(ValueError):
        moe.moe_ffn(MOE_CFG, pt, x, policy="nope")


def test_moe_ragged_gradients_match_reference():
    """The grouped product, gather and un-sort carry gradients as the
    reference's ``ragged_dot`` and scatter-add do."""
    rp, pt = both(ref_moe.init_moe, MOE_CFG, 7)
    x = rand((2, 8, 16), 8, 0.3)

    def ref_loss(p, x):
        out, aux = ref_moe.moe_ragged(MOE_CFG, p, x)
        return jnp.sum(out**2) + aux

    ref_g = jax.grad(ref_loss, argnums=(0, 1))(rp, jnp.asarray(x))
    pt = {k: v.clone().requires_grad_() for k, v in pt.items()}
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = moe.moe_ragged(MOE_CFG, pt, xt)
    (out.square().sum() + aux).backward()
    close(xt.grad, ref_g[1], MOE_TOL)
    for k in pt:
        close(pt[k].grad, ref_g[0][k], MOE_TOL, k)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


def test_rglru_block_and_stepwise_decode_match_reference():
    rp, pt = both(ref_rglru.init_rglru, RGLRU_CFG, 0)
    x = rand((2, 10, 24), 9, 0.3)
    ref_full = ref_rglru.rglru_block(RGLRU_CFG, rp, jnp.asarray(x))
    full = rglru.rglru_block(RGLRU_CFG, pt, torch.from_numpy(x))
    close(full, ref_full, RGLRU_TOL)
    state = rglru.RGLRUState.zeros(RGLRU_CFG, 2, "cpu")
    ref_state = ref_rglru.RGLRUState.zeros(RGLRU_CFG, 2)
    for t in range(10):
        out, state = rglru.rglru_decode(RGLRU_CFG, pt, torch.from_numpy(x[:, t:t + 1]), state)
        ref_out, ref_state = ref_rglru.rglru_decode(RGLRU_CFG, rp, jnp.asarray(x[:, t:t + 1]),
                                                    ref_state)
        close(out, ref_out, RGLRU_TOL, f"t={t}")
        close(out[:, 0], full[:, t], RGLRU_TOL, f"t={t}")
    close(state.h, ref_state.h, RGLRU_TOL)
    close(state.conv, ref_state.conv, RGLRU_TOL)


def test_rglru_gates_match_reference_and_decay_is_bounded():
    rp, pt = both(ref_rglru.init_rglru, RGLRU_CFG, 0)
    u = rand((4, 24), 10, 10.0)
    a_t, b_t = rglru._gates(pt, torch.from_numpy(u))
    ref_a, ref_b = ref_rglru._gates(rp, jnp.asarray(u))
    close(a_t, ref_a, RGLRU_TOL)
    close(b_t, ref_b, RGLRU_TOL)
    assert bool(((a_t > 0) & (a_t < 1)).all())


@pytest.mark.parametrize("s", [1, 7, 64, 1000])
def test_linear_scan_equals_the_sequential_recurrence(s):
    """The doubling scan composes the same maps as h_t = a_t h_{t-1} + b_t,
    at lengths past where a cumulative product of a_t would underflow."""
    rng = np.random.default_rng(s)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, s, 5)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(2, s, 5)).astype(np.float32))
    h, want = torch.zeros(2, 5), []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(rglru._linear_scan(a, b), torch.stack(want, 1),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# xLSTM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [2, 4, 16])
def test_mlstm_block_matches_reference(chunk):
    rp, pt = both(ref_xlstm.init_mlstm, XLSTM_CFG, 0)
    x = rand((1, 16, 16), 11, 0.3)
    ref = ref_xlstm.mlstm_block(XLSTM_CFG, rp, jnp.asarray(x), chunk=chunk)
    close(xlstm.mlstm_block(XLSTM_CFG, pt, torch.from_numpy(x), chunk=chunk), ref,
          MLSTM_TOL)


def test_mlstm_ragged_length_matches_reference():
    """S not a multiple of the chunk: the padded tail is dropped."""
    rp, pt = both(ref_xlstm.init_mlstm, XLSTM_CFG, 1)
    x = rand((2, 13, 16), 12, 0.3)
    ref = ref_xlstm.mlstm_block(XLSTM_CFG, rp, jnp.asarray(x), chunk=4)
    close(xlstm.mlstm_block(XLSTM_CFG, pt, torch.from_numpy(x), chunk=4), ref, MLSTM_TOL)


def test_mlstm_decode_matches_reference_and_the_chunkwise_form():
    rp, pt = both(ref_xlstm.init_mlstm, XLSTM_CFG, 0)
    x = rand((2, 12, 16), 13, 0.3)
    full = xlstm.mlstm_block(XLSTM_CFG, pt, torch.from_numpy(x), chunk=4)
    state = xlstm.MLSTMState.zeros(XLSTM_CFG, 2, "cpu")
    ref_state = ref_xlstm.MLSTMState.zeros(XLSTM_CFG, 2)
    for t in range(12):
        out, state = xlstm.mlstm_decode(XLSTM_CFG, pt, torch.from_numpy(x[:, t:t + 1]), state)
        ref_out, ref_state = ref_xlstm.mlstm_decode(XLSTM_CFG, rp, jnp.asarray(x[:, t:t + 1]),
                                                    ref_state)
        close(out, ref_out, MLSTM_TOL, f"t={t}")
        close(out[:, 0], full[:, t], MLSTM_TOL, f"t={t}")
    for ours, ref in zip(state, ref_state):
        close(ours, ref, MLSTM_TOL)


def test_mlstm_long_sequence_stable():
    """Exponential gating must not overflow on long inputs."""
    _, pt = both(ref_xlstm.init_mlstm, XLSTM_CFG, 0)
    out = xlstm.mlstm_block(XLSTM_CFG, pt, torch.from_numpy(rand((1, 256, 16), 14, 2.0)),
                            chunk=32)
    assert bool(torch.isfinite(out).all())


def test_slstm_block_and_decode_match_reference():
    rp, pt = both(ref_xlstm.init_slstm, XLSTM_CFG, 2)
    x = rand((2, 9, 16), 15, 0.3)
    ref_full = ref_xlstm.slstm_block(XLSTM_CFG, rp, jnp.asarray(x))
    full = xlstm.slstm_block(XLSTM_CFG, pt, torch.from_numpy(x))
    close(full, ref_full, RGLRU_TOL)
    state = xlstm.SLSTMState.zeros(XLSTM_CFG, 2, "cpu")
    ref_state = ref_xlstm.SLSTMState.zeros(XLSTM_CFG, 2)
    for t in range(9):
        out, state = xlstm.slstm_decode(XLSTM_CFG, pt, torch.from_numpy(x[:, t:t + 1]), state)
        ref_out, ref_state = ref_xlstm.slstm_decode(XLSTM_CFG, rp, jnp.asarray(x[:, t:t + 1]),
                                                    ref_state)
        close(out, ref_out, RGLRU_TOL, f"t={t}")
        close(out[:, 0], full[:, t], RGLRU_TOL, f"t={t}")
    for ours, ref in zip(state, ref_state):
        close(ours, ref, RGLRU_TOL)


# ---------------------------------------------------------------------------
# whole model: the three families at reduced width, float32
# ---------------------------------------------------------------------------

# Logits of the whole reduced model.  granite-moe and recurrentgemma: the
# decode tolerance (2e-4 / 2e-5), as for the dense archs' decode.  xLSTM:
# its eight blocks are exponentially gated, and each mLSTM block moves a
# float32 rounding of its products by up to ~5e-6 of its output (its
# stabilised division amplifies it); carried through 8 blocks and the head
# that is up to ~7e-4 at |logit| ~ 4, so the logits are held by their
# relative L2 error at the reference's mLSTM block tolerance, 1e-3.
LOGIT_TOL = {"granite-moe-1b-a400m": RGLRU_TOL, "recurrentgemma-2b": RGLRU_TOL}
XLSTM_REL_L2 = 1e-3


def assert_logits_close(arch, ours, ref, msg=""):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    if arch in LOGIT_TOL:
        np.testing.assert_allclose(ours, ref, **LOGIT_TOL[arch], err_msg=msg)
    else:
        rel = np.linalg.norm(ours - ref) / np.linalg.norm(ref)
        assert rel <= XLSTM_REL_L2, (msg, rel)


def model(arch, seed=0):
    cfg = get_config(arch).reduced()
    rp = ref_tf.init_params(cfg, jax.random.PRNGKey(seed))
    return cfg, rp, params_from_numpy(to_np(rp), "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_layout_matches_reference(arch):
    cfg = get_config(arch).reduced()
    ours = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ref = to_np(ref_tf.init_params(cfg, jax.random.PRNGKey(0)))
    spec = jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype)), ref)
    ours_spec = jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), ours)
    assert ours_spec == spec


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    cfg, rp, pt = model(arch)
    inputs = ref_make_inputs(cfg, 2, 40, seed=3)
    ref, ref_aux = ref_tf.forward(cfg, rp, inputs)
    out, aux = tf.forward(cfg, pt, make_inputs(cfg, 2, 40, seed=3, device="cpu"))
    assert_logits_close(arch, out, ref)
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=1e-5, atol=1e-9)
    assert (float(aux) > 0) == (arch == "granite-moe-1b-a400m")
    assert tf.count_params(pt) == ref_tf.count_params(rp)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch):
    """Eight decode steps against the reference's.  The port's states are
    views into the stacked cache written in place; a recurrent state not
    written back would leave a zero state for the next step, and from step
    1 on the logits would leave the reference's."""
    cfg, rp, pt = model(arch, seed=5)
    toks = np.array(ref_make_inputs(cfg, 2, 8, seed=6))
    ref_cache = ref_tf.init_cache(cfg, 2, 8)
    cache = tf.init_cache(cfg, 2, 8, device="cpu")
    for i in range(8):
        ref_logits, ref_cache = ref_tf.decode_step(cfg, rp, ref_cache,
                                                   jnp.asarray(toks[:, i:i + 1]), i)
        logits, cache = tf.decode_step(cfg, pt, cache, torch.from_numpy(toks[:, i:i + 1]), i)
        assert_logits_close(arch, logits, ref_logits, f"step {i}")
    full, _ = tf.forward(cfg, pt, torch.from_numpy(toks))
    assert_logits_close(arch, logits[:, 0], full[:, -1].detach().numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_cache_matches_reference(arch):
    """After eight steps every state of the cache (KV slots, RG-LRU h and
    conv tail, mLSTM C / n / m, sLSTM c / n / h / m) is the reference's."""
    cfg, rp, pt = model(arch, seed=5)
    toks = np.array(ref_make_inputs(cfg, 2, 8, seed=6))
    ref_cache = ref_tf.init_cache(cfg, 2, 8)
    cache = tf.init_cache(cfg, 2, 8, device="cpu")
    for i in range(8):
        _, ref_cache = ref_tf.decode_step(cfg, rp, ref_cache, jnp.asarray(toks[:, i:i + 1]), i)
        _, cache = tf.decode_step(cfg, pt, cache, torch.from_numpy(toks[:, i:i + 1]), i)
    ref_leaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(ref_cache)]
    ours = [t for st in cache["scanned"] + cache["remainder"] for t in st]
    assert len(ours) == len(ref_leaves)
    tol = RGLRU_TOL if arch != "xlstm-1.3b" else MLSTM_TOL
    for i, (a, b) in enumerate(zip(ours, ref_leaves)):
        assert tuple(a.shape) == b.shape
        # the -1e30 initial stabiliser compares exactly; the rest in tolerance
        np.testing.assert_allclose(a.numpy(), b, **tol, err_msg=f"leaf {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch):
    cfg, rp, pt = model(arch, seed=8)
    toks = ref_make_inputs(cfg, 1, 6, seed=9)
    ref_logits, ref_cache = ref_tf.prefill(cfg, rp, toks)
    logits, cache = tf.prefill(cfg, pt, torch.tensor(np.asarray(toks)))
    assert_logits_close(arch, logits, ref_logits)
    tol = RGLRU_TOL if arch != "xlstm-1.3b" else MLSTM_TOL
    first = cache["scanned"][0][0]
    np.testing.assert_allclose(first.numpy(), np.asarray(ref_cache["scanned"][0][0]), **tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_tokens_identical_to_reference(arch):
    cfg, rp, pt = model(arch)
    prompts = ref_make_inputs(cfg, 2, 8, seed=0)
    ref_toks, _ = ref_serve.generate(cfg, rp, prompts, 6)
    toks, lat = serve.generate(cfg, pt, make_inputs(cfg, 2, 8, seed=0, device="cpu"), 6)
    assert toks.dtype == torch.int32 and len(lat) == 6
    np.testing.assert_array_equal(toks.numpy(), np.asarray(ref_toks))


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_gradients_match_reference(arch):
    """``lm_loss`` (with the MoE aux loss) and its gradient on every
    parameter, at 2e-4.  xLSTM's gradients at init are large (up to ~400 on
    the embedding) and carry its forward's conditioning (see LOGIT_TOL):
    each leaf is held by its relative L2 error at 1e-3; its loss at 2e-4."""
    cfg, rp, pt = model(arch, seed=10)
    inputs = np.array(ref_make_inputs(cfg, 2, 12, seed=11))
    labels = np.random.default_rng(12).integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    batch = {"inputs": jnp.asarray(inputs), "labels": jnp.asarray(labels)}
    ref_loss, ref_grads = jax.value_and_grad(lambda p: ref_tf.lm_loss(cfg, p, batch))(rp)
    leaves = tree_leaves(pt)
    for t in leaves:
        t.requires_grad_()
    loss = tf.lm_loss(cfg, pt, {"inputs": torch.from_numpy(inputs),
                                "labels": torch.from_numpy(labels)})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=2e-4)
    ref_leaves = jax.tree_util.tree_leaves(ref_grads)
    assert len(grads) == len(ref_leaves)
    for i, (g, r) in enumerate(zip(grads, ref_leaves)):
        r = np.asarray(r)
        if arch == "xlstm-1.3b":
            rel = np.linalg.norm(g.numpy() - r) / np.linalg.norm(r)
            assert rel <= XLSTM_REL_L2, (i, rel)
        else:
            np.testing.assert_allclose(g.numpy(), r, rtol=2e-4, atol=2e-4,
                                       err_msg=f"leaf {i}")


# ---------------------------------------------------------------------------
# analytic FLOPs and bytes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_counts_equal_the_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    assert SHAPES.keys() == REF_SHAPES.keys()
    for name, shape in SHAPES.items():
        ref_shape = REF_SHAPES[name]
        assert dataclasses.asdict(shape) == dataclasses.asdict(ref_shape)
        assert analytic.cell_flops(cfg, shape) == ref_analytic.cell_flops(ref_cfg, ref_shape)
        for chips, shards in ((1, 1), (256, 16), (512, 32)):
            assert analytic.cell_hbm_floor_bytes(cfg, shape, chips, shards) == \
                ref_analytic.cell_hbm_floor_bytes(ref_cfg, ref_shape, chips, shards)
        for kind in set(cfg.layer_kinds):
            assert analytic.layer_macs_per_token(cfg, kind, 1000.0) == \
                ref_analytic.layer_macs_per_token(ref_cfg, kind, 1000.0)
