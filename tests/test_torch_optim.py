"""Parity of the port's optimizers, schedules and int8 gradient
compression with :mod:`repro.optim`, on the CPU, from the same numpy
inputs: within 1e-6, and ``quantize_int8`` bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro_torch import optim
from repro_torch.tree import leaf_paths, leaves, tree_map, unflatten

TOL = dict(rtol=1e-6, atol=1e-6)


def _tree(seed, scale=1.0):
    """A parameter-shaped tree: nested dicts, a list with a None, a 0-d
    leaf; numpy float32."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.normal(size=s) * scale).astype(np.float32)  # noqa: E731
    return {"emb": f(7, 5), "blocks": [{"w": f(5, 5), "b": f(5)}, None, {"w": f(5, 3)}],
            "eps": f()}


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree):
    return tree_map(lambda a: torch.tensor(a), tree)


def _close(port_tree, ref_tree, **tol):
    ref_leaves = jax.tree_util.tree_leaves(ref_tree)
    port_leaves = leaves(port_tree)
    assert len(port_leaves) == len(ref_leaves)
    for p, r in zip(port_leaves, ref_leaves):
        r = np.asarray(r)
        p = p.float().numpy() if p.dtype == torch.bfloat16 else p.numpy()
        np.testing.assert_allclose(p, r.astype(p.dtype), **(tol or TOL))


def test_tree_order_and_paths_are_jax_s():
    tree = _tree(0)
    ref_paths = [
        tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]
    ]
    assert [p for p, _ in leaf_paths(tree)] == ref_paths
    assert unflatten(tree, leaves(tree))["blocks"][1] is None
    state = optim.AdamWState(1, {"b": 2, "a": 3}, None)
    assert [p for p, _ in leaf_paths(state)] == [("step",), ("m", "a"), ("m", "b")]


@pytest.mark.parametrize("clip", [1.0, None, 1e-3])
def test_adamw_matches_reference(clip):
    """Three steps of AdamW (a warmup-cosine learning rate; the gradient
    clip off, on and far below the norm) from the same parameters and
    gradients."""
    kw = dict(lr=ref_optim.warmup_cosine(1e-2, 2, 10), grad_clip_norm=clip)
    init_r, upd_r = ref_optim.adamw(**kw)
    kw["lr"] = optim.warmup_cosine(1e-2, 2, 10)
    init_p, upd_p = optim.adamw(**kw)
    pr, pp = _jax(_tree(0)), _torch(_tree(0))
    sr, sp = init_r(pr), init_p(pp)
    assert sp.step.dtype == torch.int32 and int(sp.step) == 0
    for s in range(3):
        g = _tree(10 + s, scale=3.0)
        pr, sr = upd_r(_jax(g), sr, pr)
        pp, sp = upd_p(_torch(g), sp, pp)
        assert int(sp.step) == int(sr.step) == s + 1
        _close(pp, pr)
        _close(sp.m, sr.m)
        _close(sp.v, sr.v)
        assert all(m.dtype == torch.float32 for m in leaves(sp.m))


def test_adamw_keeps_a_bf16_parameter_bf16():
    init_r, upd_r = ref_optim.adamw(lr=1e-2)
    init_p, upd_p = optim.adamw(lr=1e-2)
    p = np.random.default_rng(1).normal(size=(6, 4)).astype(np.float32)
    g = np.random.default_rng(2).normal(size=(6, 4)).astype(np.float32)
    pr = {"w": jnp.asarray(p, jnp.bfloat16)}
    pp = {"w": torch.tensor(p).to(torch.bfloat16)}
    pr, sr = upd_r({"w": jnp.asarray(g, jnp.bfloat16)}, init_r(pr), pr)
    pp, sp = upd_p({"w": torch.tensor(g).to(torch.bfloat16)}, init_p(pp), pp)
    assert pp["w"].dtype == torch.bfloat16 and sp.m["w"].dtype == torch.float32
    np.testing.assert_array_equal(pp["w"].float().numpy(),
                                  np.asarray(pr["w"].astype(jnp.float32)))
    _close(sp.m, sr.m)
    _close(sp.v, sr.v)


def test_sgd_matches_reference():
    init_r, upd_r = ref_optim.sgd(lr=0.1)
    init_p, upd_p = optim.sgd(lr=0.1)
    pr, pp = _jax(_tree(3)), _torch(_tree(3))
    sr, sp = init_r(pr), init_p(pp)
    g = _tree(4)
    pr, sr = upd_r(_jax(g), sr, pr)
    pp, sp = upd_p(_torch(g), sp, pp)
    _close(pp, pr)
    assert int(sp.step) == int(sr.step) == 1 and sp.m is None and sp.v is None


def test_global_norm_matches_reference():
    t = _tree(5, scale=2.0)
    np.testing.assert_allclose(float(optim.global_norm(_torch(t))),
                               float(ref_optim.global_norm(_jax(t))), **TOL)


def test_schedules_match_reference():
    ref_s = ref_optim.warmup_cosine(3e-4, 7, 40, final_frac=0.2)
    port_s = optim.warmup_cosine(3e-4, 7, 40, final_frac=0.2)
    for step in range(0, 46):
        want = float(ref_s(jnp.asarray(step, jnp.int32)))
        got = port_s(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, **TOL)
    assert float(optim.constant(0.25)(torch.tensor(3))) == float(
        ref_optim.constant(0.25)(jnp.asarray(3)))


def test_quantize_int8_is_bit_equal():
    rng = np.random.default_rng(7)
    for x in (rng.normal(size=(64, 64)).astype(np.float32),
              (rng.normal(size=(300,)) * 1e-3).astype(np.float32),
              np.zeros((4,), np.float32),
              np.array([0.5, -0.5, 1.5, 127.0, -3.25], np.float32)):
        q_r, s_r = ref_optim.quantize_int8(jnp.asarray(x))
        q_p, s_p = optim.quantize_int8(torch.tensor(x))
        assert q_p.dtype == torch.int8
        assert np.array_equal(q_p.numpy(), np.asarray(q_r))
        assert np.array_equal(s_p.numpy(), np.asarray(s_r))
        np.testing.assert_allclose(
            optim.dequantize_int8(q_p, s_p).numpy(),
            np.asarray(ref_optim.dequantize_int8(q_r, s_r)), **TOL)


def test_int8_roundtrip_error_bounded():
    x = torch.tensor(np.random.default_rng(0).normal(size=(64, 64)).astype(np.float32))
    q, s = optim.quantize_int8(x)
    assert float((optim.dequantize_int8(q, s) - x).abs().max()) <= float(s) * 0.5 + 1e-6


def test_compress_and_decompress_match_reference():
    grads = _tree(8)
    ef_r = ref_optim.init_error_feedback(_jax(grads))
    ef_p = optim.init_error_feedback(_torch(grads))
    for s in range(3):
        g = _tree(20 + s)
        q_r, ef_r = ref_optim.compress_grads(_jax(g), ef_r)
        q_p, ef_p = optim.compress_grads(_torch(g), ef_p)
        _close(optim.decompress_grads(q_p), ref_optim.decompress_grads(q_r))
        _close(ef_p.residual, ef_r.residual)


def test_error_feedback_is_unbiased_over_steps():
    """Constant gradient: compressed updates converge to the true sum."""
    g = torch.full((32,), 0.01) + torch.arange(32) * 1e-4
    ef = optim.init_error_feedback(g)
    total = torch.zeros((32,))
    for _ in range(50):
        q, ef = optim.compress_grads(g, ef)
        total = total + optim.decompress_grads(q)
    np.testing.assert_allclose(total.numpy(), (g * 50).numpy(), rtol=0.02, atol=1e-4)
