"""Primitive layers: norms, MLPs, rotary and sinusoidal positions, token embedding,
the chunked cross-entropy loss.

Numerically sensitive statistics (norms, RoPE angles) run in float32
whatever the parameter/activation dtype. Matrices keep the JAX package's
``[in, out]`` layout: ``y = x @ W``.
"""
from __future__ import annotations

import math

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding.constraints import (place_head, reduce_partial, shard_act, take_last,
                                              take_rows)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Row RMSNorm over the last dim; the rmsnorm kernel's plain version."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim with a bias; mean and variance in float32."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()).to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: down( silu(x @ gate) * (x @ up) )."""
    g, u = x @ w_gate, x @ w_up
    if g.dim() == 3:
        g, u = shard_act(g, "bsf"), shard_act(u, "bsf")
    return (F.silu(g) * u) @ w_down


def gelu_mlp(x: torch.Tensor, w_in: torch.Tensor, b_in: torch.Tensor, w_out: torch.Tensor,
             b_out: torch.Tensor) -> torch.Tensor:
    """Whisper's MLP: out( gelu_tanh(x @ w_in + b_in) ) + b_out."""
    h = F.gelu(reduce_partial(x @ w_in) + b_in, approximate="tanh")
    return reduce_partial(h @ w_out) + b_out


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies [head_dim//2], float32."""
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate ``x`` [..., seq, heads, head_dim] by ``positions`` [..., seq].

    Split-half convention (rotate_half), as llama; angles in float32.
    """
    half = x.shape[-1] // 2
    inv = rope_freqs(x.shape[-1], theta, device=x.device)
    ang = positions.float()[..., None] * inv          # [..., seq, half]
    cos = torch.cos(ang)[..., None, :]                 # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def sinusoidal_positions(length: int, d_model: int, device=None) -> torch.Tensor:
    """Sinusoidal position embeddings [length, d_model], float32: sin then cos."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d_model // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(torch.tensor(10000.0, device=device), 2.0 * dim / d_model)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def embed_tokens(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return take_rows(table, tokens)


def _xent_chunk(hc: torch.Tensor, lm_head: torch.Tensor, tc: torch.Tensor,
                mc: torch.Tensor) -> torch.Tensor:
    """Sum over one chunk of ``mc``-weighted token losses, float32."""
    logits = shard_act((hc @ place_head(lm_head, hc)).float(), "bsv")   # [B, chunk, V]
    gold = take_last(logits, tc.long())
    return ((torch.logsumexp(logits, dim=-1) - gold) * mc).sum()


MIN_LOSS_CHUNK = 16


def default_loss_chunk(vocab_size: int, seq: int) -> int:
    """The loss chunk ``train_loss`` takes when its caller names none: the
    reference's (128 if the vocabulary is not a multiple of 16, else 512,
    capped at S) where that divides S, else the largest chunk dividing both.
    The reference's own rule refuses such an S (whisper-base's 448 text
    positions against 128; ROADMAP C); every S it accepts keeps its chunk.
    A chunk below ``MIN_LOSS_CHUNK`` (an odd S gives 1: S checkpointed head
    products of one position each) is refused."""
    chunk = math.gcd(seq, min(128 if vocab_size % 16 else 512, seq))
    if chunk < min(MIN_LOSS_CHUNK, seq):
        raise ValueError(f"seq {seq} leaves a loss chunk of {chunk} (vocabulary {vocab_size}); "
                         f"pass a seq with a factor of {MIN_LOSS_CHUNK} or a loss_chunk dividing it")
    return chunk


def chunked_softmax_xent(h: torch.Tensor, lm_head: torch.Tensor, targets: torch.Tensor,
                         mask: Optional[torch.Tensor] = None, chunk: int = 512) -> torch.Tensor:
    """Cross-entropy without materialising [B, S, V] logits: the mean loss over
    counted tokens.

    Loops over sequence chunks; a chunk's logits are [B, chunk, V] float32, and
    the sum of losses and the count are float32. ``mask`` (if given) is [B, S]
    with 1.0 for counted tokens. Each chunk runs under ``torch.utils.checkpoint``,
    so the backward recomputes its logits (one more head product) instead of
    keeping every chunk's: at granite-8b's V = 49152 and S = 4096 those are
    805 MB of float32 a sequence, and only one chunk's is alive at a time.
    """
    b, s, _ = h.shape
    assert s % chunk == 0, f"seq {s} not divisible by loss chunk {chunk}"
    ms = (torch.ones((b, s), dtype=torch.float32, device=h.device) if mask is None
          else mask.float())
    loss_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, s, chunk):
        part = slice(c0, c0 + chunk)
        loss_sum = loss_sum + checkpoint(_xent_chunk, h[:, part], lm_head, targets[:, part],
                                         ms[:, part], use_reentrant=False)
    return loss_sum / torch.clamp(ms.sum(), min=1.0)
