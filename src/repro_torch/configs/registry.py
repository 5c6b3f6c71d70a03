"""Architecture registry: --arch <id> -> ArchConfig."""
from __future__ import annotations

import importlib

_MODULES = {
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "phi3-medium-14b": "phi3_medium_14b",
    "stablelm-1.6b": "stablelm_1_6b",
    "minicpm3-4b": "minicpm3_4b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "whisper-medium": "whisper_medium",
    "mamba2-130m": "mamba2_130m",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "recurrentgemma-2b": "recurrentgemma_2b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def all_configs():
    return {a: get_config(a) for a in ARCH_IDS}
