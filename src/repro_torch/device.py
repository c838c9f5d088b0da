"""Device placement for the port's entry points.

Entry points run on the CUDA device unless the caller asks for another
(``device="cpu"``, as the CPU tests do).  There is no quiet move to the
CPU: with no CUDA device and no explicit device, they raise.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the current CUDA device; raises when CUDA is asked
    for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def on_device(value, device: torch.device, name: str) -> torch.Tensor:
    """A numpy array (or list) is copied to ``device``; a tensor must
    already be there."""
    if isinstance(value, torch.Tensor):
        if value.device != device:
            raise ValueError(
                f"{name} is on {value.device} but the program runs on "
                f"{device}"
            )
        return value
    return torch.as_tensor(np.asarray(value), device=device)


def worker_devices(device=None) -> list[torch.device]:
    """The devices an async front-end's workers (or a two-group PP mesh)
    spread over, ``device`` first: with two or more cards, ``device`` and
    then every other card in index order; else two workers on ``device``
    (two CUDA streams of one card, or two CPU workers)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= 2:
        return [dev] + [torch.device("cuda", i)
                        for i in range(torch.cuda.device_count()) if i != dev.index]
    return [dev, dev]
