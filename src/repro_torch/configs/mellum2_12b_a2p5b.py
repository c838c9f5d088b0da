"""mellum2-12b-a2.5b — MoE with windowed and full attention mixed
[hf:JetBrains/Mellum2-12B-A2.5B-Instruct, config.json].  The port's own
arch: the reference's registry has no such config.

28L d_model=2304 32H (GQA kv=4) head_dim=128 (not 2304 // 32 = 72),
vocab=98304, embeddings not tied.  Every layer's FFN is sparse: 64
experts, top-8 renormalised, expert width 896, SiLU-gated, no shared
expert (``intermediate_size`` 7168 is used by no layer).  Layers come in
threes of sliding-window attention (window 1024) and one of full
attention, 7 times over: ``("local_moe",) * 3 + ("moe",)``.  RoPE theta
500,000 on both kinds; the full layers add YaRN (factor 16 over an
original 8,192 positions, beta_fast 32, beta_slow 1, attention factor
0.1 ln 16 + 1).  RMSNorm eps 1e-6, no attention bias, no query/key norm.

:data:`PUBLISHED` holds ``config.json``'s keys that shape the model, and
:func:`from_published` reads such a dict (at these or smaller widths) into
an :class:`ArchConfig`, refusing what the port cannot run.
"""
from ..models.config import ArchConfig, MoEConfig, YarnConfig

_PERIOD = ["sliding_attention"] * 3 + ["full_attention"]
PUBLISHED = {
    "attention_bias": False,
    "head_dim": 128,
    "hidden_act": "silu",
    "hidden_size": 2304,
    "intermediate_size": 7168,
    "layer_types": _PERIOD * 7,
    "mlp_layer_types": ["sparse"] * 28,
    "max_position_embeddings": 131072,
    "max_window_layers": 0,
    "model_type": "mellum",
    "moe_intermediate_size": 896,
    "norm_topk_prob": True,
    "num_attention_heads": 32,
    "num_experts": 64,
    "num_experts_per_tok": 8,
    "num_hidden_layers": 28,
    "num_key_value_heads": 4,
    "rms_norm_eps": 1e-06,
    "rope_parameters": {
        "full_attention": {"rope_type": "yarn", "rope_theta": 500000, "factor": 16,
                           "original_max_position_embeddings": 8192, "beta_fast": 32,
                           "beta_slow": 1, "attention_factor": 1.2772588722239782},
        "sliding_attention": {"rope_type": "default", "rope_theta": 500000},
    },
    "sliding_window": 1024,
    "tie_word_embeddings": False,
    "vocab_size": 98304,
    "use_sliding_window": True,
}
#: ``layer_types`` -> the port's block kind (every FFN sparse)
KINDS = {"sliding_attention": "local_moe", "full_attention": "moe"}


def _refuse(what: str):
    raise ValueError(f"mellum2: the port cannot run {what}")


def from_published(c: dict, dtype: str = "bfloat16") -> ArchConfig:
    """The :class:`ArchConfig` of a Mellum2 ``config.json`` dict ``c``
    computing in ``dtype``: the block pattern is the shortest repeating
    unit of its ``layer_types``."""
    types = c["layer_types"]
    if len(types) != c["num_hidden_layers"] or set(types) - set(KINDS):
        _refuse(f"layer_types {types}")
    if set(c["mlp_layer_types"]) != {"sparse"}:
        _refuse("a dense FFN layer")
    if c["hidden_act"] != "silu" or c["attention_bias"] or not c["norm_topk_prob"]:
        _refuse("another activation, an attention bias or unnormalised top-k weights")
    if not c["use_sliding_window"]:
        _refuse("sliding_attention layers without their window")
    if c["rms_norm_eps"] != 1e-06:
        _refuse(f"rms_norm_eps {c['rms_norm_eps']}")
    period = next(p for p in range(1, len(types) + 1)
                  if all(t == types[i % p] for i, t in enumerate(types)))
    rope = c["rope_parameters"]
    full, sliding = rope["full_attention"], rope["sliding_attention"]
    if full["rope_theta"] != sliding["rope_theta"] or sliding["rope_type"] != "default" \
            or full["rope_type"] not in ("default", "yarn"):
        _refuse(f"rope_parameters {rope}")
    yarn = None
    if full["rope_type"] == "yarn":
        yarn = YarnConfig(factor=float(full["factor"]),
                          original_max_position_embeddings=full["original_max_position_embeddings"],
                          beta_fast=float(full["beta_fast"]), beta_slow=float(full["beta_slow"]),
                          attention_factor=float(full["attention_factor"]))
    return ArchConfig(
        name="mellum2-12b-a2.5b",
        family="moe",
        n_layers=c["num_hidden_layers"],
        d_model=c["hidden_size"],
        n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"],
        d_head=c["head_dim"],
        d_ff=c["moe_intermediate_size"],
        vocab=c["vocab_size"],
        block_pattern=tuple(KINDS[t] for t in types[:period]),
        window=c["sliding_window"],
        moe=MoEConfig(n_experts=c["num_experts"], top_k=c["num_experts_per_tok"]),
        rope_theta=float(full["rope_theta"]),
        tie_embeddings=c["tie_word_embeddings"],
        yarn=yarn,
        dtype=dtype,
    )


CONFIG = from_published(PUBLISHED)
