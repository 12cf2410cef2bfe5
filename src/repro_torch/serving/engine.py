"""Serve steps and a whole-batch generation loop.

Counterpart of ``repro.serving.engine`` without the sharding: greedy
decoding, or temperature sampling from an explicit ``torch.Generator``
(whose tokens are not comparable with ``jax.random``'s).
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.models.model import ModelApi


class ServeSteps(NamedTuple):
    prefill: Callable   # (params, tokens, prompt_lens, **extras) -> (logits, cache)
    decode: Callable    # (params, cache, tokens) -> (logits, next_tokens, cache)
    sample: Callable    # (logits, generator, temperature) -> tokens


def _sample(logits: torch.Tensor, generator: Optional[torch.Generator],
            temperature: float) -> torch.Tensor:
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def build_serve_steps(api: ModelApi) -> ServeSteps:
    def decode(params, cache, tokens):
        logits, cache = api.decode_step(params, cache, tokens)
        return logits, torch.argmax(logits, dim=-1).to(torch.int32), cache

    return ServeSteps(prefill=api.prefill, decode=decode, sample=_sample)


@torch.inference_mode()
def generate(api: ModelApi, params, prompts: torch.Tensor, prompt_lens: torch.Tensor,
             max_new_tokens: int, *, generator: Optional[torch.Generator] = None,
             temperature: float = 0.0,
             extras: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """Whole-batch generation: prompts [B, S] padded to the cache length S,
    prompt_lens [B], ``extras`` the prefill's keywords (``frames=``,
    ``patches=``) -> tokens [B, max_new_tokens]. The production path is the
    continuous batcher in ``repro_torch.serving.batching``."""
    extras = {k: v.to(api.device) for k, v in (extras or {}).items()}
    logits, cache = api.prefill(params, prompts.to(api.device), prompt_lens.to(api.device),
                                **extras)
    tok = _sample(logits, generator, temperature)
    out = [tok]
    for _ in range(max_new_tokens - 1):
        logits, cache = api.decode_step(params, cache, tok)
        tok = _sample(logits, generator, temperature)
        out.append(tok)
    return torch.stack(out, dim=1)
