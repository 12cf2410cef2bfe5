"""Model API: ``build(cfg, device)`` returns a ``ModelApi`` of plain functions.

Counterpart of ``repro.models.model`` for the dense, MoE, SSM and hybrid
families. The device is fixed at ``build``: ``init_params`` and
``init_cache`` allocate there, and it is ``cuda`` unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict

import torch

from repro_torch.config import ModelConfig, validate
from repro_torch.models import common, transformer


@dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig
    device: torch.device
    param_template: Dict[str, Any]
    prefill: Callable      # (params, tokens, prompt_lens) -> (logits, cache)
    decode_step: Callable  # (params, cache, tokens) -> (logits, cache)
    cache_spec: Callable   # (batch, cache_len) -> ParamSpec tree

    def init_params(self, generator: torch.Generator):
        return common.init_params(self.param_template, generator, self.device, self.cfg.dtype)

    def init_cache(self, batch: int, cache_len: int):
        return transformer.empty_cache(self.cfg, batch, cache_len, self.device)

    def param_count(self) -> int:
        return common.param_count(self.param_template)

    def param_bytes(self) -> int:
        return common.param_bytes(self.param_template, self.cfg.dtype)


def build(cfg: ModelConfig, device="cuda") -> ModelApi:
    validate(cfg)
    return ModelApi(
        cfg=cfg,
        device=common.resolve_device(device),
        param_template=transformer.param_template(cfg),
        prefill=lambda p, t, pl: transformer.prefill(p, t, pl, cfg),
        decode_step=lambda p, c, t: transformer.decode_step(p, c, t, cfg),
        cache_spec=lambda batch, cache_len: transformer.cache_spec(cfg, batch, cache_len),
    )
