"""Flash attention: the CUDA kernels ``csrc/flash_attention.cu``, their plain version
and their gradient.

Counterpart of ``repro.kernels.flash_attention``: GQA prefill attention with
an online softmax, causal and sliding-window masks. ``window`` is a runtime
int (<= 0 means full attention). ``flash_attention`` launches a kernel on
CUDA tensors and raises on anything else; ``plain`` (the chunked online
softmax the JAX model runs) is the PyTorch version the CPU path and the
tests use. On ``meta`` tensors ``flash_attention`` returns an empty output of
the kernel's shape (the dry-run); ``cost`` is the work of one call.

The source holds two kernels, and ``kernel_for`` picks one by (dtype,
head_dim): bf16 at head_dim 64 or 128, the shapes of every served model,
runs on the tensor cores (``wgmma``, any GQA group size); float32, and bf16 at
other head dims, run on the CUDA cores (at most ``MAX_GROUP`` query heads per
KV head).

``FlashAttentionFunction`` is the kernel under autograd: its forward is
``flash_attention`` (``plain`` on CPU tensors), its backward is
``flash_attention_backward``, the gradient formula in torch ops (the
reference has no backward kernel: XLA differentiates its
``chunked_attention``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.models.attention import NEG_INF, chunked_attention as plain

__all__ = ["flash_attention", "plain", "cost", "allowed_pairs", "kernel_for", "launches", "MAX_GROUP", "MAX_HEAD_DIM",
           "WGMMA_HEAD_DIMS", "flash_attention_backward", "FlashAttentionFunction"]

launches = 0  # kernel launches since the last reset (see ``ops.reset_launch_counts``)

MAX_GROUP = 64      # query heads per KV head of the CUDA-core kernel (simt::kRows)
MAX_HEAD_DIM = 128  # simt::kMaxDh; the tensor-core kernel takes WGMMA_HEAD_DIMS
WGMMA_HEAD_DIMS = (64, 128)

# float32 bytes of one block of P (and of each of its same-sized companions S, dP,
# dS) in the backward: granite-8b's [2, 32, 4096, 4096] would be 4.3 GB in one piece
BACKWARD_BLOCK_BYTES = 256 << 20

_ENTRY = {torch.float32: "flash_attention_f32", torch.bfloat16: "flash_attention_bf16"}
_WGMMA = "flash_attention_bf16_wgmma"


def kernel_for(dtype: torch.dtype, dh: int) -> str:
    """The C entry for q's dtype and head_dim: the tensor-core kernel for bf16 at
    ``WGMMA_HEAD_DIMS``, else the CUDA-core kernel of the dtype."""
    return _WGMMA if dtype == torch.bfloat16 and dh in WGMMA_HEAD_DIMS else _ENTRY[dtype]


def allowed_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) position pairs the masks allow: key j <= query i when causal, and
    i - j < window when ``window`` > 0, positions from 0 as in ``plain``."""
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(i, sk - 1) if causal else np.full_like(i, sk - 1)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros_like(i)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
         window: int = 0) -> _build.Cost:
    """QKᵀ and PV on the allowed pairs (4·dh operations a pair and query head); q, k,
    v and the output read or written once."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    flops = 4.0 * b * hq * dh * allowed_pairs(sq, sk, causal, window)
    return _build.Cost(flops, float((2 * sq * hq + 2 * sk * hkv) * b * dh * q.element_size()))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: int = 0, scale: Optional[float] = None) -> torch.Tensor:
    """q [B, Sq, Hq, dh]; k, v [B, Sk, Hkv, dh] of q's dtype -> [B, Sq, Hq, dh]."""
    global launches
    if q.device.type == "meta":
        return torch.empty_like(q)
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


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, *, causal: bool = True, window: int = 0,
                             scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``plain(q, k, v, causal=, window=, scale=)`` = ``o`` for the
    output gradient ``do``: (dq, dk, dv) in q's dtype.

    P is recomputed in float32 under the mask of ``chunked_attention``: key
    position <= query position if causal, their distance < window if window > 0;
    positions count from 0 for Sq != Sk too. Then dV = Pᵀ·dO, D = rowsum(dO ∘ O),
    dS = P ∘ (dO·Vᵀ − D), dQ = scale·dS·K, dK = scale·dSᵀ·Q. A KV head's G query
    heads are stacked as rows of one product, so their gradients sum into it. The
    products run in the input dtype and sum into float32, and the values round to
    it where the reference's differentiated ``chunked_attention`` rounds them:
    Q·Kᵀ before the scale, P before dV, scale·dS before dQ and dK. Query rows go
    in blocks whose float32 P holds at most ``BACKWARD_BLOCK_BYTES``; a block reads
    only the keys its mask can allow. A query row that allows no key (one at or
    past Sk + window - 1, which needs a window and Sq > Sk) gets no gradient and
    passes none to K and V.
    """
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = float(scale if scale is not None else dh**-0.5)
    dt, dev = q.dtype, q.device
    bh = b * hkv
    # [B·Hkv, S, G, dh]: a block of positions is a contiguous run of (position, head) rows
    rows_of = lambda t: t.reshape(b, sq, hkv, g, dh).transpose(1, 2).reshape(bh, sq, g, dh)
    qh, doh = rows_of(q), rows_of(do.contiguous())
    kh, vh = (t.transpose(1, 2).reshape(bh, sk, dh) for t in (k, v))
    delta = (do.float() * o.float()).sum(dim=-1).reshape(b, sq, hkv, g).transpose(1, 2)
    delta = delta.reshape(bh, sq * g, 1)
    dq = torch.zeros((bh, sq, g, dh), dtype=torch.float32, device=dev)
    dk = torch.zeros((bh, sk, dh), dtype=torch.float32, device=dev)
    dv = torch.zeros((bh, sk, dh), dtype=torch.float32, device=dev)
    live_rows = min(sq, sk + window - 1) if window > 0 else sq
    rows = max(1, BACKWARD_BLOCK_BYTES // (4 * b * hq * max(sk, 1)))
    scale_f32 = torch.full((1,), scale, dtype=torch.float32, device=dev)
    for q0 in range(0, live_rows, rows):
        q1 = min(live_rows, q0 + rows)
        k0 = max(0, q0 - window + 1) if window > 0 else 0
        k1 = min(sk, q1) if causal else sk
        r = (q1 - q0) * g
        qb, dob = qh[:, q0:q1].reshape(bh, r, dh), doh[:, q0:q1].reshape(bh, r, dh)
        kb, vb = kh[:, k0:k1], vh[:, k0:k1]                    # [B·Hkv, k1 - k0, dh]
        s = torch.bmm(qb, kb.transpose(1, 2))                  # [B·Hkv, r, k1 - k0]
        qpos = torch.arange(q0, q1, device=dev).repeat_interleave(g)[:, None]
        kpos = torch.arange(k0, k1, device=dev)[None, :]
        allowed = None
        if causal:
            allowed = kpos <= qpos
        if window > 0:
            near = qpos - kpos < window
            allowed = near if allowed is None else allowed & near
        if allowed is not None:
            s.masked_fill_(~allowed, NEG_INF)
        p = torch.softmax(s * scale_f32, dim=-1)   # a [1] float32 factor: the product is float32
        del s
        pt = p.to(dt)
        dv[:, k0:k1] += torch.bmm(pt.transpose(1, 2), dob)
        del pt
        # scale·dS = scale·P ∘ (dP − D); P is 0 where the mask refuses, so dS is too
        ds = torch.sub(torch.bmm(dob, vb.transpose(1, 2)), delta[:, q0 * g:q1 * g])
        ds = ds.mul_(p).mul_(scale).to(dt)
        del p
        dq[:, q0:q1] = torch.bmm(ds, kb).reshape(bh, q1 - q0, g, dh)
        dk[:, k0:k1] += torch.bmm(ds.transpose(1, 2), qb)
    dq = dq.reshape(b, hkv, sq, g, dh).transpose(1, 2).reshape(b, sq, hq, dh)
    out = lambda t: t.to(dt).contiguous()
    return out(dq), out(dk.reshape(b, hkv, sk, dh).transpose(1, 2)), \
        out(dv.reshape(b, hkv, sk, dh).transpose(1, 2))


class FlashAttentionFunction(torch.autograd.Function):
    """``flash_attention`` (the kernel; ``plain`` on the CPU) forward,
    ``flash_attention_backward`` backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        run = plain if q.device.type == "cpu" else flash_attention
        o = run(q, k, v, causal=causal, window=window, scale=scale)
        ctx.save_for_backward(q, k, v, o)
        ctx.mask = (causal, window, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        causal, window, scale = ctx.mask
        return (*flash_attention_backward(q, k, v, o, do, causal=causal, window=window,
                                          scale=scale), None, None, None)
