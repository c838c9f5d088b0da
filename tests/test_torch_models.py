"""Parity of the port's LM substrate with the reference's, on the CPU.

Inputs come from numpy with a seed, and weights are the reference's own
init carried across with ``params_from_numpy``; tolerances are those of
``tests/test_models.py`` (attention 1e-4 / 1e-5, decode 2e-4 / 2e-5), and
1e-5 / 1e-6 for the pointwise layers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as ref_serve
import repro.models.attention as ref_attn
import repro.models.layers as ref_layers
import repro.models.transformer as ref_tf
import repro_torch.launch.serve as serve
import repro_torch.models.attention as attn
import repro_torch.models.layers as layers
import repro_torch.models.transformer as tf
from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.models.stubs import make_inputs as ref_make_inputs
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import ArchConfig, make_inputs, params_from_numpy

CFG = ArchConfig(
    name="t", family="dense", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
    d_ff=64, vocab=128, attn_chunk=8,
)
ATTN_TOL = dict(rtol=1e-4, atol=1e-5)
DECODE_TOL = dict(rtol=2e-4, atol=2e-5)
LAYER_TOL = dict(rtol=1e-5, atol=1e-6)
FORWARD_ARCHS = ["smollm-135m", "tinyllama-1.1b", "olmo-1b", "musicgen-large",
                 "granite-8b", "llava-next-34b"]


def rand(shape, seed, scale=1.0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32) * scale


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def ref_params(cfg, seed=0):
    return ref_tf.init_params(cfg, jax.random.PRNGKey(seed))


def positions(b, s):
    return np.tile(np.arange(s, dtype=np.int32), (b, 1))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_are_the_reference_configs(arch):
    assert ARCH_IDS == REF_ARCH_IDS
    ours, ref = get_config(arch), ref_get_config(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.param_count() == ref.param_count()
    assert ours.layer_kinds == ref.layer_kinds
    assert dataclasses.asdict(ours.reduced()) == dataclasses.asdict(ref.reduced())


def test_gcn_paper_config_names_the_port_gnn():
    from repro_torch.configs.gcn_paper import CONFIG
    from repro_torch.gnn import GNNConfig

    assert isinstance(CONFIG, GNNConfig) and CONFIG.hidden == 16


# ---------------------------------------------------------------------------
# pointwise layers
# ---------------------------------------------------------------------------


def test_norms_match_reference():
    x, scale = rand((2, 5, 32), 1), rand((32,), 2, 0.1)
    np.testing.assert_allclose(
        layers.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(ref_layers.rmsnorm(jnp.asarray(x), jnp.asarray(scale))), **LAYER_TOL)
    np.testing.assert_allclose(
        layers.rmsnorm(torch.from_numpy(x), None).numpy(),
        np.asarray(ref_layers.rmsnorm(jnp.asarray(x), None)), **LAYER_TOL)
    np.testing.assert_allclose(
        layers.nonparam_layernorm(torch.from_numpy(x)).numpy(),
        np.asarray(ref_layers.nonparam_layernorm(jnp.asarray(x))), **LAYER_TOL)
    olmo = CFG.with_(norm="nonparam_ln")
    np.testing.assert_allclose(
        layers.norm(olmo, torch.from_numpy(x), None).numpy(),
        np.asarray(ref_layers.norm(olmo, jnp.asarray(x), None)), **LAYER_TOL)


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rope_matches_reference(theta):
    x = rand((2, 7, 3, 16), 3)
    pos = (np.arange(7, dtype=np.int32) * 3 + 5)[None].repeat(2, 0)
    ref = ref_layers.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    out = layers.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **LAYER_TOL)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_matches_reference(act):
    cfg = CFG.with_(act=act)
    p = to_np(ref_layers.init_mlp(cfg, jax.random.PRNGKey(4)))
    x = rand((2, 5, 32), 5)
    ref = ref_layers.mlp(cfg, jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    out = layers.mlp(cfg, params_from_numpy(p, "cpu"), torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **LAYER_TOL)


@pytest.mark.parametrize("tie", [False, True])
def test_embed_and_head_match_reference(tie):
    cfg = CFG.with_(tie_embeddings=tie)
    p = to_np(ref_layers.init_embeddings(cfg, jax.random.PRNGKey(6)))
    assert ("lm_head" in p) is not tie
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, 5)).astype(np.int32)
    h = ref_layers.embed_tokens(cfg, p, jnp.asarray(toks))
    ours = layers.embed_tokens(cfg, params_from_numpy(p, "cpu"), torch.from_numpy(toks))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(h))
    np.testing.assert_allclose(
        layers.logits_head(cfg, params_from_numpy(p, "cpu"), ours).numpy(),
        np.asarray(ref_layers.logits_head(cfg, p, h)), **LAYER_TOL)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["seq", "sp_opt"])
@pytest.mark.parametrize("n_kv", [1, 2, 4])
def test_attention_matches_reference(policy, n_kv):
    cfg = CFG.with_(attn_policy=policy, n_kv_heads=n_kv)
    p = to_np(ref_attn.init_attention(cfg, jax.random.PRNGKey(0)))
    x, pos = rand((2, 24, 32), 8, 0.3), positions(2, 24)
    ref = ref_attn.attention(cfg, p, jnp.asarray(x), jnp.asarray(pos))
    out = attn.attention(cfg, params_from_numpy(p, "cpu"), torch.from_numpy(x),
                         torch.from_numpy(pos))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **ATTN_TOL)


def test_attention_plain_twin_is_the_cpu_route():
    p = params_from_numpy(to_np(ref_attn.init_attention(CFG, jax.random.PRNGKey(0))), "cpu")
    x, pos = torch.from_numpy(rand((1, 12, 32), 9, 0.3)), torch.from_numpy(positions(1, 12))
    assert torch.equal(attn.attention(CFG, p, x, pos),
                       attn.attention(CFG, p, x, pos, use_kernels=False))


@pytest.mark.parametrize("window", [0, 6])
def test_decode_attention_matches_reference(window):
    cfg = CFG.with_(window=window) if window else CFG
    p = to_np(ref_attn.init_attention(cfg, jax.random.PRNGKey(1)))
    pt = params_from_numpy(p, "cpu")
    x = rand((2, 14, 32), 10, 0.3)
    ref_cache = ref_attn.KVCache.zeros(cfg, 2, 14, window=window)
    cache = attn.KVCache.zeros(cfg, 2, 14, window=window, device="cpu")
    assert tuple(cache.k.shape) == tuple(ref_cache.k.shape)
    for step in range(14):
        ref_out, ref_cache = ref_attn.decode_attention(
            cfg, p, jnp.asarray(x[:, step:step + 1]), ref_cache, step, window=window)
        out, cache = attn.decode_attention(
            cfg, pt, torch.from_numpy(x[:, step:step + 1]), cache, step, window=window)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **DECODE_TOL,
                                   err_msg=f"step {step}")
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(ref_cache.k), **DECODE_TOL)


def test_head_alignment_matches_reference():
    for ts in (1, 2, 4, 8, 16):
        for arch in ("smollm-135m", "granite-8b", "llava-next-34b"):
            cfg = get_config(arch)
            assert attn.head_alignment(cfg, ts) == ref_attn.head_alignment(
                ref_get_config(arch), ts)
    assert attn.head_alignment(CFG) == (1, 2, False)


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", FORWARD_ARCHS)
def test_forward_matches_reference(arch):
    cfg = get_config(arch).reduced()
    rp = ref_params(cfg)
    inputs = ref_make_inputs(cfg, 2, 40, seed=3)
    ref, _ = ref_tf.forward(cfg, rp, inputs)
    pt = params_from_numpy(to_np(rp), "cpu")
    ours = make_inputs(cfg, 2, 40, seed=3, device="cpu")
    np.testing.assert_array_equal(ours.numpy(), np.asarray(inputs))
    out, aux = tf.forward(cfg, pt, ours)
    assert float(aux) == 0.0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **ATTN_TOL)
    assert tf.count_params(pt) == ref_tf.count_params(rp)


def test_forward_with_remainder_layers_matches_reference():
    cfg = CFG.with_(n_layers=3, block_pattern=("attn", "attn"))
    rp = ref_params(cfg, seed=2)
    assert len(rp["remainder"]) == 1
    toks = ref_make_inputs(cfg, 2, 16, seed=4)
    ref, _ = ref_tf.forward(cfg, rp, toks)
    out, _ = tf.forward(cfg, params_from_numpy(to_np(rp), "cpu"),
                        torch.tensor(np.asarray(toks)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **ATTN_TOL)


def test_decode_steps_match_reference():
    cfg = get_config("smollm-135m").reduced()
    rp = ref_params(cfg, seed=5)
    pt = params_from_numpy(to_np(rp), "cpu")
    toks = np.array(ref_make_inputs(cfg, 2, 10, seed=6))
    ref_cache = ref_tf.init_cache(cfg, 2, 10)
    cache = tf.init_cache(cfg, 2, 10, device="cpu")
    for i in range(10):
        ref_logits, ref_cache = ref_tf.decode_step(cfg, rp, ref_cache,
                                                   jnp.asarray(toks[:, i:i + 1]), i)
        logits, cache = tf.decode_step(cfg, pt, cache, torch.from_numpy(toks[:, i:i + 1]), i)
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **DECODE_TOL,
                                   err_msg=f"step {i}")
    # the last position's decode logits equal the forward's
    full, _ = tf.forward(cfg, pt, torch.from_numpy(toks))
    np.testing.assert_allclose(logits[:, 0].numpy(), full[:, -1].numpy(), **DECODE_TOL)


def test_prefill_matches_reference():
    cfg = get_config("tinyllama-1.1b").reduced()
    rp = ref_params(cfg, seed=8)
    toks = ref_make_inputs(cfg, 1, 6, seed=9)
    ref_logits, ref_cache = ref_tf.prefill(cfg, rp, toks)
    logits, cache = tf.prefill(cfg, params_from_numpy(to_np(rp), "cpu"),
                               torch.tensor(np.asarray(toks)))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **ATTN_TOL)
    np.testing.assert_allclose(cache["scanned"][0].k.numpy(),
                               np.asarray(ref_cache["scanned"][0].k), **DECODE_TOL)


def test_generate_tokens_identical_to_reference():
    cfg = get_config("smollm-135m").reduced()
    rp = ref_params(cfg, seed=0)
    prompts = ref_make_inputs(cfg, 2, 8, seed=0)
    ref_toks, _ = ref_serve.generate(cfg, rp, prompts, 6)
    timings = {}
    toks, lat = serve.generate(cfg, params_from_numpy(to_np(rp), "cpu"),
                               make_inputs(cfg, 2, 8, seed=0, device="cpu"), 6,
                               timings=timings)
    assert toks.dtype == torch.int32 and len(lat) == 6
    assert set(timings) == {"prefill_s", "replay_s", "decode_s"}
    np.testing.assert_array_equal(toks.numpy(), np.asarray(ref_toks))


@pytest.mark.parametrize("arch", ["musicgen-large", "llava-next-34b"])
def test_generate_embedded_arch_tokens_identical_to_reference(arch):
    """The embedded-input archs decode through a 64-row table; given the
    reference's table (drawn from jax.random.PRNGKey(7)), greedy tokens are
    the reference's."""
    cfg = get_config(arch).reduced()
    assert cfg.embedded_inputs
    rp = ref_params(cfg, seed=0)
    prompts = ref_make_inputs(cfg, 2, 8, seed=0)
    ref_toks, _ = ref_serve.generate(cfg, rp, prompts, 5)
    table = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (64, cfg.d_model)) * 0.05)
    toks, _ = serve.generate(cfg, params_from_numpy(to_np(rp), "cpu"),
                             make_inputs(cfg, 2, 8, seed=0, device="cpu"), 5,
                             decode_table=table)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(ref_toks))


def test_generate_sampling_is_seeded():
    cfg = get_config("smollm-135m").reduced()
    params = tf.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    prompts = make_inputs(cfg, 2, 5, seed=1, device="cpu")
    runs = [serve.generate(cfg, params, prompts, 4, greedy=False,
                           generator=torch.Generator().manual_seed(3))[0]
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1]) and runs[0].shape == (2, 4)


def test_init_params_layout_matches_reference():
    cfg = get_config("olmo-1b").reduced()
    ours = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ref = to_np(ref_params(cfg))
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), ref)
    ours_shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), ours)
    assert ours_shapes == shapes
    again = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(ours["scanned"][0]["attn"]["wq"], again["scanned"][0]["attn"]["wq"])


def test_params_from_numpy_carries_bf16_weights():
    cfg = get_config("smollm-135m").reduced(dtype="bfloat16")
    rp = to_np(ref_params(cfg))
    pt = params_from_numpy(rp, "cpu")
    wq, ref_wq = pt["scanned"][0]["attn"]["wq"], rp["scanned"][0]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16 and tuple(wq.shape) == ref_wq.shape
    np.testing.assert_array_equal(wq.float().numpy(), ref_wq.astype(np.float32))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_params_and_forward_run_for_every_arch(arch):
    """Every arch of the registry builds and runs in the port (reduced,
    float32, on the CPU): finite logits of the right shape, the block
    kinds' states in the cache."""
    cfg = get_config(arch).reduced()
    params = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    inputs = make_inputs(cfg, 2, 10, seed=0, device="cpu")
    logits, aux = tf.forward(cfg, params, inputs)
    assert logits.shape == (2, 10, cfg.vocab) and bool(torch.isfinite(logits).all())
    assert bool(torch.isfinite(aux))
    cache = tf.init_cache(cfg, 2, 10, device="cpu")
    step, _ = tf.decode_step(cfg, params, cache, inputs[:, :1], 0)
    assert step.shape == (2, 1, cfg.vocab) and bool(torch.isfinite(step).all())


def test_entry_points_need_a_device_where_there_is_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cfg = get_config("smollm-135m").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tf.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_inputs(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced", "--new-tokens", "1"])


def test_serve_main_runs_on_the_cpu(capsys):
    assert serve.main(["--reduced", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "6", "--new-tokens", "3"]) == 0
    assert "generated (2, 3) tokens on cpu" in capsys.readouterr().out
