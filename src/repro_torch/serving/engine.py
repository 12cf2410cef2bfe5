"""Serve steps, their sharded form over a ``DeviceMesh``, and a whole-batch
generation loop.

Counterpart of ``repro.serving.engine``: greedy decoding, or temperature
sampling from an explicit ``torch.Generator`` (whose tokens are not
comparable with ``jax.random``'s).

``jit_serve_steps`` is the reference's sharded prefill and decode. The
steps are eager ("jit" keeps the reference's name): each places its inputs
by the in-shardings (``sharding.rules.place``: a plain tensor is
distributed, a DTensor placed otherwise redistributed, one placed so left
alone), runs the model on DTensors and places its outputs by the
out-shardings. Decode writes the cache in place, the counterpart of
``donate_argnums``. The model runs under ``implicit_replication``: the
plain tensors it builds from global shapes (positions, masks, index
tensors) are the same on every rank and are taken as replicated; the
kernels run on local shards (``kernels.ops``). The steps run under
``torch.no_grad()``: DTensor views fail under ``inference_mode``.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.config.parallel import ParallelPlan
from repro_torch.models.model import ModelApi
from repro_torch.sharding.constraints import argmax_last
from repro_torch.sharding.rules import (batch_sharding, cache_shardings, param_shardings, place,
                                        place_tree, step_mesh)


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
        return logits, argmax_last(logits).to(torch.int32), cache

    return ServeSteps(prefill=api.prefill, decode=decode, sample=_sample)


def serve_shardings(api: ModelApi, plan: ParallelPlan, mesh, batch: int, cache_len: int):
    """(param_shardings, cache_shardings, token_sharding), by the serve rules, on
    ``sharding.rules.step_mesh``'s mesh."""
    mesh, plan = step_mesh(mesh, plan, (batch,))
    psh = param_shardings(api.param_template, mesh, plan, kind="serve")
    csh = cache_shardings(api.cache_spec(batch, cache_len), mesh, plan)
    tsh = batch_sharding(plan, mesh, batch)
    return psh, csh, tsh


def jit_serve_steps(api: ModelApi, plan: ParallelPlan, mesh, batch: int, cache_len: int, *,
                    extras: Tuple[str, ...] = ()):
    """(prefill, decode, (psh, csh, tsh)): ``prefill(params, tokens, prompt_lens,
    *extra_vals) -> (logits, cache)`` and ``decode(params, cache, tokens) ->
    (logits, next_tokens, cache)`` on ``mesh``. ``extras`` names the prefill's
    further inputs ("frames" / "patches"), sharded over the data axes on dim 0."""
    steps = build_serve_steps(api)
    psh, csh, tsh = serve_shardings(api, plan, mesh, batch, cache_len)

    @torch.no_grad()
    def prefill(params, tokens, prompt_lens, *extra_vals):
        params = place_tree(params, psh)
        kw = {name: place(v, tsh) for name, v in zip(extras, extra_vals)}
        with implicit_replication():
            logits, cache = steps.prefill(params, place(tokens, tsh), place(prompt_lens, tsh),
                                          **kw)
        return place(logits, tsh), place_tree(cache, csh)

    @torch.no_grad()
    def decode(params, cache, tokens):
        params, cache = place_tree(params, psh), place_tree(cache, csh)
        with implicit_replication():
            logits, nxt, cache = steps.decode(params, cache, place(tokens, tsh))
        return place(logits, tsh), place(nxt, tsh), place_tree(cache, csh)

    return prefill, decode, (psh, csh, tsh)


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
