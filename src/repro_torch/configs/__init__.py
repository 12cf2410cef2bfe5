"""Architecture registry: ``get_config(arch_id)`` / ``get_smoke(arch_id)``.

Each module exposes ``full()`` (the published config) and ``smoke()`` (a
reduced same-family config for CPU tests). All ten of the reference's
architectures are registered, in its order.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.config import ModelConfig, validate
from repro_torch.configs import (deepseek_67b, glm4_9b, granite_8b, hymba_1p5b, internvl2_76b,
                                 mamba2_130m, olmoe_1b_7b, qwen3_moe_235b, qwen25_32b,
                                 whisper_base)

_MODULES = {m.ARCH_ID: m for m in (deepseek_67b, glm4_9b, qwen25_32b, granite_8b, whisper_base,
                                   hymba_1p5b, internvl2_76b, mamba2_130m, olmoe_1b_7b,
                                   qwen3_moe_235b)}

ARCH_IDS: List[str] = list(_MODULES)


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return _MODULES[arch_id]


def get_config(arch_id: str) -> ModelConfig:
    cfg = _module(arch_id).full()
    validate(cfg)
    return cfg


def get_smoke(arch_id: str) -> ModelConfig:
    cfg = _module(arch_id).smoke()
    validate(cfg)
    return cfg


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
