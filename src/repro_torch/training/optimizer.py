"""AdamW with decoupled weight decay and float32 moments.

Counterpart of ``repro.training.optimizer``, with its arithmetic: b2 0.95,
a global-norm clip at 1.0 in float32, bias correction, weight decay only on
leaves of ``ndim >= 2``, the update in float32 cast back to the parameter's
dtype, and a linear-warmup cosine schedule. ``torch.optim.AdamW`` differs
(it decays every tensor, has no global clip and another schedule), so this
is plain functions on trees of tensors.

Where the reference returns new trees, ``adamw_update`` writes the
parameters and the moments in place, a layer of a stacked leaf at a time:
at granite-8b's width a float32 temporary of the whole ``w_gate`` stack is
3.8 GB per 16 layers, and the update needs several. The clip and the update
are the device-timed spans ``train.clip`` and ``train.adamw`` (``core.tracing``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import tracing
from repro_torch.models.common import tree_items, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor    # scalar int32
    mu: Any               # first moment tree (float32)
    nu: Any               # second moment tree (float32)


def _zeros_like_f32(tree):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), tree)


def adamw_init(params) -> AdamWState:
    """Zero moments on each parameter's device; the step counter on the host."""
    return AdamWState(step=torch.zeros((), dtype=torch.int32), mu=_zeros_like_f32(params),
                      nu=_zeros_like_f32(params))


def abstract_adamw_state(abstract_params) -> AdamWState:
    """The state ``adamw_init`` makes for ``abstract_params``, as ``meta`` tensors."""
    f32 = lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta")
    return AdamWState(step=torch.empty((), dtype=torch.int32, device="meta"),
                      mu=tree_map(f32, abstract_params), nu=tree_map(f32, abstract_params))


def _cosine_lr(step: int, base_lr: float, warmup: int, total: int) -> float:
    """The learning rate of step ``step`` (from 0), in float32 as the reference's:
    linear warmup over ``warmup`` steps, then a cosine to 0 at ``total``."""
    f32 = np.float32
    s = f32(step)
    if s < warmup:
        return float(f32(base_lr) * (s + f32(1)) / f32(max(1, warmup)))
    prog = np.clip((s - f32(warmup)) / f32(max(1, total - warmup)), f32(0), f32(1))
    return float(f32(base_lr) * f32(0.5) * (f32(1) + np.cos(f32(math.pi) * prog)))


def _layers(t: torch.Tensor):
    """A stacked leaf ([L, ...], ndim >= 3) a layer at a time; any other leaf whole."""
    return t.unbind(0) if t.dim() >= 3 else (t,)


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *, lr: float = 3e-4, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
                 warmup_steps: int = 100, total_steps: int = 10000, grad_clip: float = 1.0
                 ) -> Tuple[Any, AdamWState, Dict[str, Any]]:
    """One AdamW step: (params, new state, metrics ``grad_norm``, ``lr``).

    ``params``, ``state.mu`` and ``state.nu`` are updated in place and returned;
    ``grads`` is any tree of the parameters' structure (bf16 or float32)."""
    step = int(state.step)
    lr_t = _cosine_lr(step, lr, warmup_steps, total_steps)

    flat_g = [g for _, g in tree_items(grads)]
    # global-norm clip in float32 (a layer at a time: no float32 copy of a whole stack)
    with tracing.span("train.clip", device=True):
        sq = sum(gl.float().square().sum() for g in flat_g for gl in _layers(g))
        gnorm = torch.sqrt(sq)
        scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)

    t = np.float32(step + 1)
    bc1 = float(np.float32(1) - np.float32(b1) ** t)
    bc2 = float(np.float32(1) - np.float32(b2) ** t)
    flat = zip((p for _, p in tree_items(params)), flat_g,
               (m for _, m in tree_items(state.mu)), (v for _, v in tree_items(state.nu)))
    with tracing.span("train.adamw", device=True):
        for p, g, m, v in flat:
            wd = weight_decay if p.dim() >= 2 else 0.0   # decoupled decay on matrices only
            for pl, gl, ml, vl in zip(_layers(p), _layers(g), _layers(m), _layers(v)):
                gf = gl.float() * scale
                ml.mul_(b1).add_(gf, alpha=1.0 - b1)
                vl.mul_(b2).addcmul_(gf, gf, value=1.0 - b2)
                upd = (ml / bc1).div_((vl / bc2).sqrt_().add_(eps))
                pf = pl.float()
                pl.copy_(pf - lr_t * upd.add_(pf, alpha=wd))
    metrics = {"grad_norm": gnorm, "lr": torch.tensor(lr_t, dtype=torch.float32)}
    return params, AdamWState(state.step + 1, state.mu, state.nu), metrics
