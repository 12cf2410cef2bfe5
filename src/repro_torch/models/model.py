"""Model API: ``build(cfg, device)`` returns a ``ModelApi`` of plain functions.

Counterpart of ``repro.models.model`` for every family: ``encdec`` is
``models.encdec``, the others ``models.transformer``. The device is fixed at
``build``: ``init_params`` and ``init_cache`` allocate there, and it is
``cuda`` unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict

import torch

from repro_torch.config import ModelConfig, validate
from repro_torch.models import common, encdec, transformer


@dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig
    device: torch.device
    param_template: Dict[str, Any]
    train_loss: Callable   # (params, batch, **kw) -> scalar loss (``remat``, ``loss_chunk``, ...)
    prefill: Callable      # (params, tokens, prompt_lens, **extras) -> (logits, cache)
    decode_step: Callable  # (params, cache, tokens) -> (logits, cache)
    cache_spec: Callable   # (batch, cache_len) -> ParamSpec tree
    empty_cache: Callable  # (batch, cache_len, device) -> cache tree

    def abstract_params(self):
        """The parameters as ``meta`` tensors: shapes and dtypes, no storage."""
        return common.abstract_params(self.param_template, self.cfg.dtype)

    def logical_axes(self):
        return common.logical_axes(self.param_template)

    def cache_logical_axes(self, batch: int, cache_len: int):
        return common.logical_axes(self.cache_spec(batch, cache_len))

    def abstract_cache(self, batch: int, cache_len: int):
        """The cache spec's shapes and dtypes as ``meta`` tensors, as the
        reference's ``abstract_cache`` gives them (a leaf whose spec names no
        dtype takes the model's)."""
        return common.abstract_params(self.cache_spec(batch, cache_len), self.cfg.dtype)

    def init_params(self, generator: torch.Generator):
        return common.init_params(self.param_template, generator, self.device, self.cfg.dtype)

    def init_cache(self, batch: int, cache_len: int):
        """Zero K/V, ``slot_pos`` -1, ``pos`` 0. The encdec cache has the model's
        dtype, as in the reference's ``ModelApi.init_cache``; the decoder-only
        families' K/V are bf16 whatever the model's dtype (``transformer.CACHE_DTYPE``)."""
        return self.empty_cache(batch, cache_len, self.device)

    def param_count(self) -> int:
        return common.param_count(self.param_template)

    def param_bytes(self) -> int:
        return common.param_bytes(self.param_template, self.cfg.dtype)


def build(cfg: ModelConfig, device="cuda") -> ModelApi:
    """``prefill`` takes the family's inputs as keywords: ``frames=`` [B, F, D]
    (encdec), ``patches=`` [B, P, D] (vlm)."""
    validate(cfg)
    mod = encdec if cfg.family == "encdec" else transformer
    return ModelApi(
        cfg=cfg,
        device=common.resolve_device(device),
        param_template=mod.param_template(cfg),
        train_loss=lambda p, b, **kw: mod.train_loss(p, b, cfg, **kw),
        prefill=lambda p, t, pl, **extras: mod.prefill(p, t, pl, cfg, **extras),
        decode_step=lambda p, c, t: mod.decode_step(p, c, t, cfg),
        cache_spec=lambda batch, cache_len: mod.cache_spec(cfg, batch, cache_len),
        empty_cache=lambda batch, cache_len, device: mod.empty_cache(cfg, batch, cache_len, device),
    )
