"""Architecture configuration for the LM substrate.

One :class:`ArchConfig` describes any of the assigned architectures (dense
llama-family, VLM/audio backbones, MoE, RG-LRU hybrid, xLSTM).  The block
pattern is a repeating unit of block kinds:

  * ``attn``   — full causal self-attention + MLP
  * ``local``  — sliding-window attention + MLP
  * ``moe``    — attention + mixture-of-experts FFN
  * ``local_moe`` — sliding-window attention + mixture-of-experts FFN
                 (port only: Mellum2's windowed layers)
  * ``rglru``  — RG-LRU recurrent block + MLP (Griffin/RecurrentGemma)
  * ``mlstm``  — matrix-memory xLSTM block (no FFN)
  * ``slstm``  — scalar-memory xLSTM block (no FFN)

Fields past the reference's (``d_head``, ``yarn``) are the port's own; at
their defaults a config computes what the reference's does.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 32
    top_k: int = 8
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class YarnConfig:
    """YaRN's rotary frequencies (Peng et al. 2023, arXiv:2309.00071), as
    the published ``rope_type: "yarn"`` computes them: each frequency
    blends the original and the ``factor``-times-slower one by a ramp over
    the dimensions whose wavelength lies between ``beta_fast`` and
    ``beta_slow`` rotations in ``original_max_position_embeddings``
    positions, and cos and sin are scaled by ``attention_factor``."""

    factor: float
    original_max_position_embeddings: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    attention_factor: float = 1.0


#: block kinds that attend (with a KV cache), over a window, and with MoE
ATTENTION_KINDS = ("attn", "local", "moe", "local_moe")
WINDOWED_KINDS = ("local", "local_moe")
MOE_KINDS = ("moe", "local_moe")


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | vlm | audio | moe | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    block_pattern: tuple[str, ...] = ("attn",)
    window: int = 2048  # local-attention window (hybrid archs)
    moe: MoEConfig | None = None
    norm: str = "rmsnorm"  # rmsnorm | nonparam_ln | layernorm
    act: str = "silu"  # silu (SwiGLU) | gelu (GeGLU)
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    embedded_inputs: bool = False  # vlm/audio stubs feed embeddings directly
    d_rnn: int = 0  # RG-LRU recurrence width (0 -> d_model)
    conv_width: int = 4
    dtype: str = "float32"  # compute dtype ("bfloat16" for the dry-run)
    remat: bool = True
    attn_chunk: int = 512  # SP-optimized chunked-attention KV block
    # Multiphase policy for the attention GEMM-GEMM chain: "sp_opt" is the
    # paper's fused dataflow (chunked online softmax); "seq" materializes
    # the S x S score matrix (only feasible for small smoke shapes).
    attn_policy: str = "sp_opt"
    # the port's own fields (not in the reference's config)
    d_head: int = 0  # head width where it is not d_model // n_heads (0 -> that)
    # YaRN on the full-attention layers (windowed layers keep plain RoPE)
    yarn: YarnConfig | None = None

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def rnn_width(self) -> int:
        return self.d_rnn or self.d_model

    @property
    def layer_kinds(self) -> tuple[str, ...]:
        """Per-layer block kinds, tiling the pattern over n_layers."""
        reps = -(-self.n_layers // len(self.block_pattern))
        return (self.block_pattern * reps)[: self.n_layers]

    @property
    def is_subquadratic(self) -> bool:
        """True when no block attends over the full sequence (long_500k
        eligibility)."""
        return all(k not in ("attn", "moe") for k in self.block_pattern)

    def window_of(self, kind: str) -> int:
        """The attention window of a block kind (0: full attention)."""
        return self.window if kind in WINDOWED_KINDS else 0

    def param_count(self) -> int:
        """Analytic parameter count (used for 6·N·D roofline FLOPs).  The
        final norm's ``d_model`` scales are left out, as the reference
        leaves them out: a model's parameter tree holds that many more."""
        d, hd = self.d_model, self.head_dim
        total = 0
        if not self.embedded_inputs:
            total += self.vocab * d  # input embedding
        total += self.vocab * d if not self.tie_embeddings else 0  # head
        for kind in self.layer_kinds:
            if kind in ATTENTION_KINDS:
                attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd)
                attn += (self.n_heads * hd) * d
                total += attn
                if kind in MOE_KINDS:
                    e = self.moe.n_experts
                    total += d * e  # router
                    total += e * (3 * d * self.d_ff)  # gated experts
                else:
                    total += 3 * d * self.d_ff  # SwiGLU/GeGLU
            elif kind == "rglru":
                r = self.rnn_width
                total += 2 * d * r + r * d  # in/gate/out projections
                total += self.conv_width * r + 3 * r  # conv + gates
                total += 3 * d * self.d_ff
            elif kind in ("mlstm", "slstm"):
                total += 4 * d * d + 3 * d  # qkv/out + gates (approx)
            total += 2 * d  # norms
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE uses top_k of n_experts)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        e, k = self.moe.n_experts, self.moe.top_k
        expert_params = sum(
            3 * self.d_model * self.d_ff * e
            for kind in self.layer_kinds
            if kind in MOE_KINDS
        )
        return full - expert_params + expert_params * k // e

    def reduced(self, **overrides) -> "ArchConfig":
        """Smoke-test scale config of the same family (assignment: small
        layers/width/experts/tables, one forward step on CPU)."""
        small = dict(
            n_layers=max(2, len(self.block_pattern)),
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, 4 * self.n_kv_heads // self.n_heads),
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            window=16,
            d_rnn=64 if self.d_rnn else 0,
            attn_chunk=32,
            dtype="float32",
        )
        if self.moe is not None:
            small["moe"] = MoEConfig(n_experts=4, top_k=2)
        small.update(overrides)
        return dataclasses.replace(self, **small)

    def with_(self, **overrides) -> "ArchConfig":
        return dataclasses.replace(self, **overrides)
