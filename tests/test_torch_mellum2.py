"""Mellum2-12B-A2.5B on the port, held on the CPU against its plain
reference (``tests/mellum2_reference.py``, float32, no port code) on
seeded random weights at a small size: the whole model's logits with the
3:1 pattern of windowed and full layers and both RoPE kinds, the
``local_moe`` block alone, YaRN's frequencies against their closed form at
the published sizes, prefill against decode through the ring cache past
the window, the published config and its parameter counts, and the
counters and spans the block adds.
"""
import ast
import copy
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import mellum2_reference as ref
from repro_torch import trace
from repro_torch.configs import ARCH_IDS, PORT_ARCH_IDS, get_config
from repro_torch.configs.mellum2_12b_a2p5b import CONFIG, PUBLISHED, from_published
from repro_torch.models import attention as attn
from repro_torch.models import layers, moe
from repro_torch.models import transformer as tf
from repro_torch.models.config import YarnConfig

REPO = Path(__file__).resolve().parents[1]
NAME = "mellum2-12b-a2.5b"
#: float32 on both sides, summed in other orders (the chunked online
#: softmax against the materialised one, the grouped product against one
#: expert at a time): the reference suite's attention tolerance, scaled by
#: the largest logit
TOL = 1e-4
#: decode's plain softmax over the ring cache against the chunked prefill:
#: the reference suite's decode tolerance
DECODE_TOL = 2e-4


def small(seq_window=8, original=16, layers_=8):
    """The published config at a small size: every kind of layer in its
    3:1 order, a head width other than hidden // heads, a window and a
    YaRN context that a 40-token prompt runs past."""
    m = copy.deepcopy(PUBLISHED)
    m.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=2, head_dim=32,
             num_experts=8, num_experts_per_tok=2, moe_intermediate_size=32, vocab_size=128,
             num_hidden_layers=layers_, layer_types=PUBLISHED["layer_types"][:layers_],
             mlp_layer_types=["sparse"] * layers_, sliding_window=seq_window, dtype="float32")
    m["rope_parameters"]["full_attention"].update(
        rope_theta=10000, original_max_position_embeddings=original, factor=4,
        attention_factor=0.1 * math.log(4) + 1)
    m["rope_parameters"]["sliding_attention"]["rope_theta"] = 10000
    return m, from_published(m, dtype="float32").with_(attn_chunk=16)


def draw(m, seed, batch=2, seq=40):
    g = torch.Generator().manual_seed(seed)
    params = ref.init_params(m, g, "cpu")
    return params, torch.randint(0, m["vocab_size"], (batch, seq), generator=g)


def close(got, want, tol):
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=tol, atol=tol * scale)


# ---------------------------------------------------------------------------
# the config
# ---------------------------------------------------------------------------


def test_the_registered_config_is_the_published_one():
    cfg = get_config(NAME)
    assert NAME in PORT_ARCH_IDS and NAME not in ARCH_IDS and cfg is CONFIG
    assert cfg.head_dim == 128 and cfg.d_model // cfg.n_heads == 72
    assert cfg.layer_kinds == (("local_moe",) * 3 + ("moe",)) * 7
    assert [cfg.window_of(k) for k in cfg.layer_kinds[:4]] == [1024, 1024, 1024, 0]
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab) == (
        2304, 32, 4, 896, 98304)
    assert (cfg.moe.n_experts, cfg.moe.top_k, cfg.rope_theta) == (64, 8, 500000.0)
    assert cfg.yarn == YarnConfig(16.0, 8192, 32.0, 1.0, 0.1 * math.log(16) + 1)
    assert not cfg.tie_embeddings and cfg.dtype == "bfloat16"


def test_the_benchmarks_configuration_holds_the_published_keys():
    """The benchmark's configuration file states every published key as
    the registry's ``PUBLISHED`` has it, with nothing reduced."""
    c = json.loads((REPO / "perfbench" / "configs" / f"{NAME}.json").read_text())
    assert {k: c[k] for k in PUBLISHED} == PUBLISHED
    assert c["reduced"] == [] and c["dtype"] == "bfloat16"
    assert from_published(c, dtype=c["dtype"]) == CONFIG


def test_the_flash_yardstick_counts_what_the_kernels_flop_formula_counts(monkeypatch):
    """``flash_attention_roofline`` divides each layer's work, as its metric
    file counts it at the prefill cell's shapes, by the kernel's time; the
    kernel's own FLOP formula (``attend_flops``, the custom op's) must count
    the same operations for both layer types, or the share goes stale."""
    import importlib.util

    from repro_torch.kernels.flash_attention.ops import attend_flops

    bench = REPO / "perfbench"
    monkeypatch.syspath_prepend(str(bench))  # the metric file imports yardstick
    spec = importlib.util.spec_from_file_location(
        "flash_attention_roofline", bench / "metrics" / "flash_attention_roofline.py")
    metric = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(metric)
    c = json.loads((bench / "configs" / f"{NAME}.json").read_text())
    traffic = json.loads((bench / "traffic" / "prefill.json").read_text())
    b, s = traffic["batch"], traffic["seq_len"]
    hq, hkv, d = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
    work = metric.work(c, b, s)
    assert len(work) == len(c["layer_types"]) == 28
    by_type = {}
    for (_, n_ops), kind in zip(work, c["layer_types"]):
        window = c["sliding_window"] if kind == "sliding_attention" else 0
        assert n_ops == attend_flops((b, s, hq, d), (b, s, hkv, d), window)
        by_type[kind] = n_ops
    assert set(by_type) == {"sliding_attention", "full_attention"}
    assert by_type["sliding_attention"] < by_type["full_attention"]


@pytest.mark.parametrize("change, what", [
    ({"mlp_layer_types": ["dense"] + ["sparse"] * 27}, "dense FFN"),
    ({"norm_topk_prob": False}, "unnormalised"),
    ({"use_sliding_window": False}, "without their window"),
    ({"rms_norm_eps": 1e-5}, "rms_norm_eps"),
])
def test_what_the_port_cannot_run_is_refused(change, what):
    with pytest.raises(ValueError, match=what):
        from_published({**PUBLISHED, **change})


def test_param_counts():
    """12.15 B in all and 2.44 B a token, as the parameter tree holds them;
    the analytic counts leave out the final norm's 2,304 scales, as the
    reference's counts do for its archs."""
    params = tf.init_params(CONFIG, None, "meta")
    total = tf.count_params(params)
    assert total == 12_149_915_904
    experts = sum(int(np.prod(t.shape)) for st in params["scanned"]
                  for t in st["moe"].values() if t.dim() == 4)
    assert total - experts + experts * 8 // 64 == 2_439_053_568
    d = CONFIG.d_model
    assert CONFIG.param_count() == total - d
    assert CONFIG.active_param_count() == 2_439_053_568 - d


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def test_yarn_frequencies_are_the_closed_form():
    """At the published sizes: dim 128, base 500,000, factor 16 over 8,192
    positions; the ramp runs from dimension 18 to 35."""
    d, base, y = 128, 500000.0, CONFIG.yarn
    assert layers.yarn_correction_range(d, base, y) == (18, 35)
    i = np.arange(64, dtype=np.float64)
    pos = base ** (2 * i / d)
    ramp = np.clip((i - 18) / (35 - 18), 0, 1)
    want = 1 / (16 * pos) * ramp + 1 / pos * (1 - ramp)
    np.testing.assert_allclose(layers.yarn_inv_freq(d, base, y), want, rtol=1e-6)
    np.testing.assert_allclose(
        ref.inv_freq(d, PUBLISHED["rope_parameters"]["full_attention"]).numpy(), want,
        rtol=1e-12)
    assert y.attention_factor == pytest.approx(0.1 * math.log(16) + 1, rel=1e-15)


def test_rope_kinds_by_layer():
    """YaRN scales every rotated pair by ``attention_factor`` (so q . k by
    its square) on the full layers; the windowed layers keep plain RoPE."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(1, 9, 2, 128, generator=g)
    pos = torch.arange(9).expand(1, 9) * 1000
    plain = layers.rope(x, pos, 500000.0)
    yarn = layers.rope(x, pos, 500000.0, CONFIG.yarn)
    torch.testing.assert_close(yarn.norm(dim=-1), x.norm(dim=-1) * CONFIG.yarn.attention_factor)
    torch.testing.assert_close(plain.norm(dim=-1), x.norm(dim=-1))
    for kind, want in (("moe", yarn), ("local_moe", plain)):
        cfg = CONFIG.with_(d_model=256, n_heads=2, n_kv_heads=2, dtype="float32")
        p = {w: torch.eye(256) for w in ("wq", "wk", "wv", "wo")}
        q, k, _ = attn._project_qkv(cfg, p, x.reshape(1, 9, 256), pos, cfg.window_of(kind))
        torch.testing.assert_close(q, want)
        torch.testing.assert_close(k, want)


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches_the_plain_reference(seed):
    m, cfg = small()
    params, tokens = draw(m, seed)
    logits, _ = tf.forward(cfg, params, tokens)
    want = ref.forward(params, m, tokens, range(tokens.shape[1]))
    close(logits, want, TOL)


def test_the_local_moe_block_alone():
    m, cfg = small()
    params, _ = draw(m, 2)
    x = torch.randn(2, 40, 64, generator=torch.Generator().manual_seed(4))
    pos = torch.arange(40)
    p = tf._index(params["scanned"][0], 1)  # layer 4: windowed attention, then the MoE
    got, _ = tf.apply_block(cfg, "local_moe", p, x, pos.expand(2, 40))
    r = ref.layer_params(params, m, 4)
    eps, mm = m["rms_norm_eps"], torch.matmul
    h = x + ref.attention(ref.rmsnorm(x, r["ln1"], eps), r["attn"], m, "sliding_attention",
                          pos, lambda t: t, mm)
    want = h + ref.moe(ref.rmsnorm(h, r["ln2"], eps), r["moe"], m, mm)
    close(got, want, TOL)


def test_prefill_then_decode_through_the_ring_cache():
    """Each position's logits from decoding token by token through the
    caches (the windowed layers' a ring of 8 slots, 24 positions long)
    against the prefill's at that position."""
    m, cfg = small()
    params, tokens = draw(m, 5, seq=24)
    logits, _ = tf.forward(cfg, params, tokens)
    cache = tf.init_cache(cfg, 2, 24, "cpu")
    assert cache["scanned"][0].k.shape[2] == 8 and cache["scanned"][3].k.shape[2] == 24
    step = [tf.decode_step(cfg, params, cache, tokens[:, i:i + 1], i)[0][:, 0]
            for i in range(24)]
    close(torch.stack(step, 1), logits, DECODE_TOL)


# ---------------------------------------------------------------------------
# counters and spans
# ---------------------------------------------------------------------------


def test_the_moe_counts_its_calls_launches_and_dispatch_bytes():
    m, cfg = small()
    params, tokens = draw(m, 6)
    before, launches = trace.counters(), moe.grouped_mm.launches
    tf.forward(cfg, params, tokens)
    after = trace.counters()
    rows = tokens.numel() * m["num_experts_per_tok"]
    assert after["moe.calls"] - before.get("moe.calls", 0) == 8
    assert after["moe.dispatch_bytes"] - before.get("moe.dispatch_bytes", 0) == 8 * 2 * rows * 64 * 4
    assert moe.grouped_mm.launches - launches == 3 * 8


def test_a_profiled_forward_spans_each_blocks_attention_and_moe(tmp_path):
    m, cfg = small(layers_=4)
    params, tokens = draw(m, 7)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tf.forward(cfg, params, tokens)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    names = [e["name"] for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"]
    assert names.count("repro_torch.model.attention") == 4
    assert names.count("repro_torch.model.moe") == 4


# ---------------------------------------------------------------------------
# the reference itself
# ---------------------------------------------------------------------------


def test_the_reference_imports_only_torch_and_is_the_benchmarks():
    path = Path(ref.__file__)
    tree = ast.parse(path.read_text())
    mods = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
    mods |= {n.module.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert mods <= {"__future__", "contextlib", "math", "torch"}
    assert (REPO / "perfbench" / "references" / "mellum2.py").read_bytes() == path.read_bytes()


def test_the_reference_counts_the_published_prefill():
    """93.5 TFLOP for one 16,384-token prompt with logits at every position."""
    c = dict(PUBLISHED)
    assert ref.flops(c, 1, 16384) == pytest.approx(93.5e12, rel=2e-3)
    assert ref.attended_pairs(16384, 1024) == 1024 * 1025 // 2 + 15360 * 1024
    assert ref.attended_pairs(100, 0) == ref.attended_pairs(100, 200) == 5050


# ---------------------------------------------------------------------------
# on the card (``cuda``: skips where there is none; no CPU mode of the kernel)
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernel has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 1024])
def test_flash_at_mellum2s_heads_on_the_card(card, window):
    """GQA 32 / 4 at head dim 128 over 4,096 positions, full and within a
    1,024 window (key blocks behind it skipped), bf16 on the tensor cores:
    against the plain version in bf16 at the kernel suite's 2e-2, and each
    row against it in float32 within 1e-2 relative L2 (the kernel rounds P
    to bf16).  Head dim 128 runs the pingpong schedule, which counts its
    launch."""
    from repro_torch.kernels.flash_attention import attend, attend_chunked, flash_attention

    g = torch.Generator(device=card).manual_seed(11)
    q = torch.randn(1, 4096, 32, 128, generator=g, device=card).bfloat16()
    k, v = (torch.randn(1, 4096, 4, 128, generator=g, device=card).bfloat16() for _ in "kv")
    pos = torch.arange(4096, device=card, dtype=torch.int32)
    before = flash_attention.launches
    pingpong = trace.counters().get("flash.tc_pingpong_launches", 0)
    out = attend(q, k, v, pos, pos, window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert trace.counters()["flash.tc_pingpong_launches"] == pingpong + 1
    torch.testing.assert_close(out, attend_chunked(q, k, v, pos, pos, window),
                               rtol=2e-2, atol=2e-2)
    ref32 = attend_chunked(q.float(), k.float(), v.float(), pos, pos, window)
    row = (out.float() - ref32).norm(dim=-1) / ref32.norm(dim=-1)
    assert float(row.max()) <= 1e-2, float(row.max())


@pytest.mark.cuda
def test_the_model_on_the_card_matches_the_reference(card):
    """The small model in float32 on the card (the flash kernel a layer,
    three grouped products a layer) against the float32 reference there,
    TF32 off on both sides."""
    from repro_torch.kernels.flash_attention import flash_attention

    m, cfg = small()
    g = torch.Generator(device=card).manual_seed(12)
    params = ref.init_params(m, g, card)
    tokens = torch.randint(0, m["vocab_size"], (2, 40), generator=g, device=card)
    flash, grouped = flash_attention.launches, moe.grouped_mm.launches
    logits, _ = tf.forward(cfg, params, tokens)
    torch.cuda.synchronize()
    assert flash_attention.launches - flash == 8 and moe.grouped_mm.launches - grouped == 24
    close(logits, ref.forward(params, m, tokens, range(40)), TOL)
