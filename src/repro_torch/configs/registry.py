"""Architecture registry: ``--arch <id>`` lookup for all assigned configs
(copied from :mod:`repro.configs.registry`; every id resolves, though only
the dense ``attn`` archs run in the port so far), and for the port's own
archs (``PORT_ARCH_IDS``), which the reference has not."""
from __future__ import annotations

import importlib

from ..models.config import ArchConfig

ARCH_IDS = (
    "granite-8b",
    "olmo-1b",
    "tinyllama-1.1b",
    "smollm-135m",
    "llava-next-34b",
    "musicgen-large",
    "granite-moe-1b-a400m",
    "granite-moe-3b-a800m",
    "recurrentgemma-2b",
    "xlstm-1.3b",
)
#: archs of the port alone; ``get_config`` resolves them too
PORT_ARCH_IDS = ("mellum2-12b-a2.5b",)

_MODULES = {
    "granite-8b": "granite_8b",
    "olmo-1b": "olmo_1b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "smollm-135m": "smollm_135m",
    "llava-next-34b": "llava_next_34b",
    "musicgen-large": "musicgen_large",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "xlstm-1.3b": "xlstm_1_3b",
    "mellum2-12b-a2.5b": "mellum2_12b_a2p5b",
}


def get_config(arch: str) -> ArchConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; have {ARCH_IDS + PORT_ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def all_configs() -> dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
