"""Abstract input stand-ins for every (arch x shape) cell.

Counterpart of ``repro.launch.specs``: ``meta`` tensors of the step inputs'
shapes and dtypes in place of ``jax.ShapeDtypeStruct``s. They allocate
nothing, so a full-size cell's inputs can be described on any host.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.config.shapes import ShapeConfig
from repro_torch.models.common import torch_dtype
from repro_torch.models.model import ModelApi, build


def _meta(shape, dtype: str) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=torch_dtype(dtype), device="meta")


def extras_for(cfg: ModelConfig, batch: int) -> Dict[str, Any]:
    """Modality-frontend stubs: precomputed frame/patch embeddings."""
    if cfg.family == "encdec":
        return {"frames": _meta((batch, cfg.encoder_frames, cfg.d_model), cfg.dtype)}
    if cfg.family == "vlm":
        return {"patches": _meta((batch, cfg.num_patches, cfg.d_model), cfg.dtype)}
    return {}


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    batch = {
        "tokens": _meta((b, s), "int32"),
        "targets": _meta((b, s), "int32"),
    }
    batch.update(extras_for(cfg, b))
    return batch


def prefill_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[Any, ...]:
    """(tokens, prompt_lens, *extras) for the prefill step."""
    b, s = shape.global_batch, shape.seq_len
    base = (
        _meta((b, s), "int32"),
        _meta((b,), "int32"),
    )
    return base + tuple(extras_for(cfg, b).values())


def decode_input_specs(api: ModelApi, shape: ShapeConfig) -> Tuple[Any, Any]:
    """(cache, tokens) for the single-new-token step.

    The cache covers ``seq_len`` context ("one new token with a KV cache of
    seq_len").
    """
    b, s = shape.global_batch, shape.seq_len
    cache = api.abstract_cache(b, s)
    tokens = _meta((b,), "int32")
    return cache, tokens


def input_specs(cfg: ModelConfig, shape: ShapeConfig, api: ModelApi = None):
    """Uniform entry: returns a dict keyed by step-input name."""
    api = api or build(cfg, device="meta")
    if shape.kind == "train":
        return {"batch": train_batch_specs(cfg, shape)}
    if shape.kind == "prefill":
        toks, plens, *extras = prefill_input_specs(cfg, shape)
        out = {"tokens": toks, "prompt_lens": plens}
        for name, v in zip(extras_for(cfg, shape.global_batch), extras):
            out[name] = v
        return out
    cache, tokens = decode_input_specs(api, shape)
    return {"cache": cache, "tokens": tokens}
