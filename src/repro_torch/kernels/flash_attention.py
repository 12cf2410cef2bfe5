"""Flash attention: the CUDA kernel ``csrc/flash_attention.cu`` and its plain version.

Counterpart of ``repro.kernels.flash_attention``: GQA prefill attention with
an online softmax, causal and sliding-window masks. ``window`` is a runtime
int (<= 0 means full attention). ``flash_attention`` launches the kernel on
CUDA tensors and raises on anything else; ``plain`` (the chunked online
softmax the JAX model runs) is the PyTorch version the CPU path and the
tests use.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.models.attention import chunked_attention as plain

__all__ = ["flash_attention", "plain", "launches", "MAX_GROUP", "MAX_HEAD_DIM"]

launches = 0  # kernel launches since the last reset (see ``ops.reset_launch_counts``)

MAX_GROUP = 64      # query heads per KV head (kRows in the source)
MAX_HEAD_DIM = 128  # kMaxDh in the source

_ENTRY = {torch.float32: "flash_attention_f32", torch.bfloat16: "flash_attention_bf16"}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: int = 0, scale: Optional[float] = None) -> torch.Tensor:
    """q [B, Sq, Hq, dh]; k, v [B, Sk, Hkv, dh] of q's dtype -> [B, Sq, Hq, dh]."""
    global launches
    _build.check_inputs("flash_attention", q.device, q=q, k=k, v=v)
    _build.require(q.dtype in _ENTRY, f"flash_attention: dtype {q.dtype} not supported")
    _build.require(k.dtype == q.dtype and v.dtype == q.dtype,
                   "flash_attention: k and v must have q's dtype")
    _build.require(q.dim() == 4 and k.dim() == 4, "flash_attention: q [B,Sq,Hq,dh], k/v [B,Sk,Hkv,dh]")
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    _build.require(tuple(k.shape) == (b, sk, hkv, dh) and v.shape == k.shape,
                   "flash_attention: k/v shapes disagree with q")
    _build.require(hkv > 0 and hq % hkv == 0 and hq // hkv <= MAX_GROUP,
                   f"flash_attention: needs Hq % Hkv == 0 and Hq/Hkv <= {MAX_GROUP}")
    _build.require(0 < dh <= MAX_HEAD_DIM, f"flash_attention: head_dim must be <= {MAX_HEAD_DIM}")
    scale = float(scale if scale is not None else dh**-0.5)
    out = torch.empty_like(q)
    fn = getattr(_build.library("flash_attention"), _ENTRY[q.dtype])
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, sk, hq, hkv,
                    dh, scale, int(bool(causal)), int(window), _build.stream(q.device)),
                 "flash_attention")
    launches += 1
    return out
