"""repro_torch — the PyTorch / CUDA port of :mod:`repro` for NVIDIA Hopper.

The front door is :func:`repro_torch.compile`: search a model-level
dataflow schedule (or accept one), lower it to executable kernel knobs, and
get a frozen :class:`repro_torch.api.Program` that runs on the CUDA device
(``device="cpu"`` to run the plain PyTorch versions on the CPU).  Dense-LM
serving lives in :mod:`repro_torch.launch.serve` and
:mod:`repro_torch.models`.

Float32 matrix products run in full float32: importing the package turns
TF32 off for ``torch.matmul`` (TF32 keeps about three decimal digits, which
would break parity with the reference).
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False

from .api import Program, compile, trace_count, workload_fingerprint  # noqa: E402
from .core.hw import LatencyModel  # noqa: E402

__all__ = [
    "LatencyModel",
    "Program",
    "compile",
    "trace_count",
    "workload_fingerprint",
]
