"""Optimizers on trees of tensors (the port of :mod:`repro.optim`)."""
from .adamw import AdamWState, adamw, global_norm, sgd
from .schedule import constant, warmup_cosine
from .compression import (
    EFState,
    compress_grads,
    decompress_grads,
    dequantize_int8,
    init_error_feedback,
    quantize_int8,
)
