"""The LM substrate (the port of :mod:`repro.models`): dense ``attn``
blocks so far, with the flash-attention kernel on the prefill path and
``lm_loss`` (plain versions) for training."""
from .config import ArchConfig, MoEConfig
from .stubs import make_inputs, synthetic_embeddings, synthetic_tokens
from .transformer import (
    count_params,
    decode_step,
    forward,
    init_cache,
    init_params,
    lm_loss,
    params_from_numpy,
    prefill,
)
