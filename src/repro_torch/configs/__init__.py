"""Architecture registry: ``get_config(arch_id)`` / ``get_smoke(arch_id)``.

Each module exposes ``full()`` (the published config) and ``smoke()`` (a
reduced same-family config for CPU tests). The dense, MoE, SSM and hybrid
families are ported.
"""
from __future__ import annotations

from typing import List

from repro_torch.config import ModelConfig, validate
from repro_torch.configs import granite_8b, hymba_1p5b, mamba2_130m, olmoe_1b_7b, qwen3_moe_235b

_MODULES = {m.ARCH_ID: m for m in (granite_8b, olmoe_1b_7b, qwen3_moe_235b, mamba2_130m,
                                   hymba_1p5b)}

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
