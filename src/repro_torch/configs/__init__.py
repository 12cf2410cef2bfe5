"""Architecture registry: ``get_config(arch_id)`` / ``get_smoke(arch_id)``.

Each module exposes ``full()`` (the published config) and ``smoke()`` (a
reduced same-family config for CPU tests). Only the dense family is ported.
"""
from __future__ import annotations

from typing import List

from repro_torch.config import ModelConfig, validate
from repro_torch.configs import granite_8b

_MODULES = {granite_8b.ARCH_ID: granite_8b}

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
