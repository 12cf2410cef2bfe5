"""Flash attention: the CUDA kernels ``csrc/flash_attention.cu`` and their plain version.

Counterpart of ``repro.kernels.flash_attention``: GQA prefill attention with
an online softmax, causal and sliding-window masks. ``window`` is a runtime
int (<= 0 means full attention). ``flash_attention`` launches a kernel on
CUDA tensors and raises on anything else; ``plain`` (the chunked online
softmax the JAX model runs) is the PyTorch version the CPU path and the
tests use.

The source holds two kernels, and ``kernel_for`` picks one by (dtype,
head_dim): bf16 at head_dim 64 or 128, the shapes of every served model,
runs on the tensor cores (``wgmma``, any GQA group size); float32, and bf16 at
other head dims, run on the CUDA cores (at most ``MAX_GROUP`` query heads per
KV head).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.models.attention import chunked_attention as plain

__all__ = ["flash_attention", "plain", "kernel_for", "launches", "MAX_GROUP", "MAX_HEAD_DIM",
           "WGMMA_HEAD_DIMS"]

launches = 0  # kernel launches since the last reset (see ``ops.reset_launch_counts``)

MAX_GROUP = 64      # query heads per KV head of the CUDA-core kernel (simt::kRows)
MAX_HEAD_DIM = 128  # simt::kMaxDh; the tensor-core kernel takes WGMMA_HEAD_DIMS
WGMMA_HEAD_DIMS = (64, 128)

_ENTRY = {torch.float32: "flash_attention_f32", torch.bfloat16: "flash_attention_bf16"}
_WGMMA = "flash_attention_bf16_wgmma"


def kernel_for(dtype: torch.dtype, dh: int) -> str:
    """The C entry for q's dtype and head_dim: the tensor-core kernel for bf16 at
    ``WGMMA_HEAD_DIMS``, else the CUDA-core kernel of the dtype."""
    return _WGMMA if dtype == torch.bfloat16 and dh in WGMMA_HEAD_DIMS else _ENTRY[dtype]


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
    _build.require(hkv > 0 and hq % hkv == 0, "flash_attention: needs Hq % Hkv == 0")
    entry = kernel_for(q.dtype, dh)
    if entry == _WGMMA:
        _build.require(all(t.data_ptr() % 16 == 0 for t in (q, k, v)),
                       "flash_attention: q, k and v must be 16-byte aligned")
    else:
        _build.require(hq // hkv <= MAX_GROUP and 0 < dh <= MAX_HEAD_DIM,
                       f"flash_attention: needs Hq/Hkv <= {MAX_GROUP} and head_dim <= "
                       f"{MAX_HEAD_DIM}")
    scale = float(scale if scale is not None else dh**-0.5)
    out = torch.empty_like(q)
    fn = getattr(_build.library("flash_attention"), entry)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, sk, hq, hkv,
                    dh, scale, int(bool(causal)), int(window), _build.stream(q.device)),
                 "flash_attention")
    launches += 1
    return out
