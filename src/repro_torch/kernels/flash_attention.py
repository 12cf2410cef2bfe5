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
``forward_with_lse`` (the kernel, which also writes each row's logsumexp;
``plain`` on CPU tensors), its backward is ``backward``, the backward kernels
of the same source (``plain_backward``, the gradient formula in torch ops, on
CPU tensors; the reference has no backward kernel: XLA differentiates its
``chunked_attention``). ``chunked_backward_reference`` is the backward
kernels' passes in float32 PyTorch, for the tests.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.models.attention import NEG_INF, chunked_attention as plain

__all__ = ["flash_attention", "plain", "cost", "allowed_pairs", "kernel_for", "launches", "MAX_GROUP", "MAX_HEAD_DIM",
           "WGMMA_HEAD_DIMS", "forward_with_lse", "plain_lse", "plain_backward",
           "chunked_backward_reference",
           "backward", "backward_cost", "backward_launches", "FlashAttentionFunction"]

launches = 0  # kernel launches since the last reset (see ``ops.reset_launch_counts``)
backward_launches = 0  # backward kernel launches since the last reset

MAX_GROUP = 64      # query heads per KV head of the CUDA-core kernel (simt::kRows)
MAX_HEAD_DIM = 128  # simt::kMaxDh; the tensor-core kernel takes WGMMA_HEAD_DIMS
WGMMA_HEAD_DIMS = (64, 128)

# float32 bytes of one block of P (and of each of its same-sized companions S, dP,
# dS) in the backward: granite-8b's [2, 32, 4096, 4096] would be 4.3 GB in one piece;
# and at most BACKWARD_BLOCK_ROWS query positions a block, so that a causal block's
# masked pairs, which it multiplies all the same, stay a small share at any batch
# (whisper-base's train_4k backward at 2 sequences a rank: 1024-row blocks multiply
# 1.25x the causal pairs, 512-row blocks 1.12x)
BACKWARD_BLOCK_BYTES = 256 << 20
BACKWARD_BLOCK_ROWS = 512

_ENTRY = {torch.float32: "flash_attention_f32", torch.bfloat16: "flash_attention_bf16"}
_WGMMA = "flash_attention_bf16_wgmma"
# each forward entry's backward entry: the same split by (dtype, head_dim)
_BACKWARD_ENTRY = {e: e.replace("flash_attention_", "flash_attention_backward_")
                   for e in (*_ENTRY.values(), _WGMMA)}


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


def _check_forward(what: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """Refuse what the kernels do not take; the C entry for q's dtype and head_dim."""
    _build.check_inputs(what, q.device, q=q, k=k, v=v)
    _build.require(q.dtype in _ENTRY, f"{what}: dtype {q.dtype} not supported")
    _build.require(k.dtype == q.dtype and v.dtype == q.dtype, f"{what}: k and v must have q's dtype")
    _build.require(q.dim() == 4 and k.dim() == 4, f"{what}: q [B,Sq,Hq,dh], k/v [B,Sk,Hkv,dh]")
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    _build.require(tuple(k.shape) == (b, sk, hkv, dh) and v.shape == k.shape,
                   f"{what}: k/v shapes disagree with q")
    _build.require(hkv > 0 and hq % hkv == 0, f"{what}: needs Hq % Hkv == 0")
    entry = kernel_for(q.dtype, dh)
    if entry == _WGMMA:
        _build.require(all(t.data_ptr() % 16 == 0 for t in (q, k, v)),
                       f"{what}: q, k and v must be 16-byte aligned")
    else:
        _build.require(hq // hkv <= MAX_GROUP and 0 < dh <= MAX_HEAD_DIM,
                       f"{what}: needs Hq/Hkv <= {MAX_GROUP} and head_dim <= {MAX_HEAD_DIM}")
    return entry


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, window: int,
             scale: Optional[float], lse: Optional[torch.Tensor]) -> torch.Tensor:
    global launches
    entry = _check_forward("flash_attention", q, k, v)
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    scale = float(scale if scale is not None else dh**-0.5)
    out = torch.empty_like(q)
    fn = getattr(_build.library("flash_attention"), entry)
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    None if lse is None else lse.data_ptr(), b, sq, sk, hq, hkv, dh, scale,
                    int(bool(causal)), int(window), _build.stream(q.device)), "flash_attention")
    launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: int = 0, scale: Optional[float] = None) -> torch.Tensor:
    """q [B, Sq, Hq, dh]; k, v [B, Sk, Hkv, dh] of q's dtype -> [B, Sq, Hq, dh]."""
    if q.device.type == "meta":
        return torch.empty_like(q)
    return _forward(q, k, v, causal, window, scale, None)


def forward_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                     window: int = 0, scale: Optional[float] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention``'s launch that also writes each row's logsumexp of its scaled
    scores: (out, lse float32 [B, Hq, Sq], natural units, -inf on a row that allows no
    key), what the backward kernels read."""
    b, sq, hq, _ = q.shape
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    if q.device.type == "meta":
        return torch.empty_like(q), lse
    return _forward(q, k, v, causal, window, scale, lse), lse


def plain_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
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
    in blocks of at most ``BACKWARD_BLOCK_ROWS`` positions whose float32 P holds at
    most ``BACKWARD_BLOCK_BYTES``; a block reads only the keys its mask can allow.
    A query row that allows no key (one at or past Sk + window - 1, which needs a
    window and Sq > Sk) gets no gradient and passes none to K and V.
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
    rows = max(1, min(BACKWARD_BLOCK_ROWS, BACKWARD_BLOCK_BYTES // (4 * b * hq * max(sk, 1))))
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


def _allowed(sq: int, sk: int, causal: bool, window: int, device) -> torch.Tensor:
    """[Sq, Sk] bool: the (query, key) position pairs the masks allow (``allowed_pairs``)."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        ok = ok & (kpos <= qpos)
    if window > 0:
        ok = ok & (qpos - kpos < window)
    return ok


def plain_lse(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True, window: int = 0,
              scale: Optional[float] = None, rows: int = 512) -> torch.Tensor:
    """Each query row's logsumexp of its allowed scaled scores in float32, what
    ``forward_with_lse`` writes: [B, Hq, Sq], -inf on a row that allows no key. Query
    rows go ``rows`` positions at a time."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = float(scale if scale is not None else dh**-0.5)
    qf = q.float().reshape(b, sq, hkv, g, dh)
    kf = k.float()
    ok = _allowed(sq, sk, causal, window, q.device)
    out = []
    for q0 in range(0, sq, rows):
        q1 = min(sq, q0 + rows)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf[:, q0:q1], kf) * scale
        out.append(torch.logsumexp(s.masked_fill(~ok[q0:q1], float("-inf")), dim=-1))
    return torch.cat(out, dim=-1).reshape(b, hq, sq)


def chunked_backward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                               causal: bool = True, window: int = 0,
                               scale: Optional[float] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' passes in float32 PyTorch: (dq, dk, dv) in q's dtype.

    (a) D = rowsum(dO ∘ O); (b) for each block of 128 keys, dK and dV summed over the G
    query heads in turn and each head's 64-position query blocks that the mask lets
    reach the block, from P = exp(scale·QKᵀ − lse); (c) for each block of 128 query
    positions, dQ summed over the 64-key tiles its mask reaches. The kernels' blocks
    hold 64 or 128 rows; a row's sums are the same in either (a tile that adds nothing
    to a row's sum adds exact zeros). P and scale·dS round to q's dtype before their
    products, as the kernels round them; everything else is float32."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = float(scale if scale is not None else dh**-0.5)
    dt = q.dtype
    rnd = (lambda t: t) if dt == torch.float32 else (lambda t: t.to(dt).float())
    heads = lambda t: t.float().reshape(b, t.shape[1], hkv, g, dh).permute(0, 2, 3, 1, 4)
    qh, doh = heads(q), heads(do)                                   # [B, Hkv, G, Sq, dh]
    kh, vh = (t.float().transpose(1, 2) for t in (k, v))            # [B, Hkv, Sk, dh]
    delta = (do.float() * o.float()).sum(-1).reshape(b, sq, hkv, g).permute(0, 2, 3, 1)
    lse = lse.reshape(b, hkv, g, sq)
    ok = _allowed(sq, sk, causal, window, q.device)

    def probs(s, lse_rows, mask):
        return torch.where(mask, torch.exp(s * scale - lse_rows), torch.zeros((), device=s.device))

    dk = torch.zeros((b, hkv, sk, dh), device=q.device)
    dv = torch.zeros_like(dk)
    n_qt = -(-sq // 64)
    for k0 in range(0, sk, 128):                                    # (b)
        k1 = min(sk, k0 + 128)
        qt0 = min(k0 // 64, n_qt) if causal else 0
        qt1 = min(n_qt, (k0 + 127 + window - 1) // 64 + 1) if window > 0 else n_qt
        kb, vb = kh[:, :, k0:k1], vh[:, :, k0:k1]
        for gi in range(g):
            for q0 in range(qt0 * 64, qt1 * 64, 64):
                q1 = min(sq, q0 + 64)
                qb, dob = qh[:, :, gi, q0:q1], doh[:, :, gi, q0:q1]
                p = probs(kb @ qb.transpose(-1, -2), lse[:, :, gi, None, q0:q1],
                          ok[q0:q1, k0:k1].T)                      # Pᵀ [B, Hkv, keys, queries]
                ds = rnd(p * (vb @ dob.transpose(-1, -2) - delta[:, :, gi, None, q0:q1]) * scale)
                dv[:, :, k0:k1] += rnd(p) @ dob
                dk[:, :, k0:k1] += ds @ qb
    dq = torch.zeros_like(qh)
    for q0 in range(0, sq, 128):                                    # (c)
        q1 = min(sq, q0 + 128)
        t0 = max(0, q0 - window + 1) // 64 if window > 0 else 0
        t1 = min(-(-sk // 64), (q0 + 127) // 64 + 1) if causal else -(-sk // 64)
        qb, dob = qh[:, :, :, q0:q1], doh[:, :, :, q0:q1]
        for k0 in range(t0 * 64, t1 * 64, 64):
            k1 = min(sk, k0 + 64)
            kb, vb = kh[:, :, None, k0:k1], vh[:, :, None, k0:k1]
            p = probs(qb @ kb.transpose(-1, -2), lse[..., q0:q1, None], ok[q0:q1, k0:k1])
            ds = rnd(p * (dob @ vb.transpose(-1, -2) - delta[..., q0:q1, None]) * scale)
            dq[:, :, :, q0:q1] += ds @ kb
    out = lambda t: t.to(dt).contiguous()
    return (out(dq.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dh)), out(dk.transpose(1, 2)),
            out(dv.transpose(1, 2)))


def backward_cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                  window: int = 0) -> _build.Cost:
    """dV, dP, dQ and dK on the allowed pairs (8·dh operations a pair and query head; the
    recompute of P is the kernels' choice, not the gradient's work); q, k, v, o, dO and
    the float32 lse read once, dq, dk and dv written once."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    flops = 8.0 * b * hq * dh * allowed_pairs(sq, sk, causal, window)
    return _build.Cost(flops, float((4 * sq * hq + 4 * sk * hkv) * b * dh * q.element_size()
                                    + 4 * b * hq * sq))


def backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
             lse: torch.Tensor, do: torch.Tensor, *, causal: bool = True, window: int = 0,
             scale: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels: q, k, v, the forward's o and lse (``forward_with_lse``) and
    dO of o's shape -> (dq, dk, dv) in q's dtype."""
    global backward_launches
    if q.device.type == "meta":
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    what = "flash_attention backward"
    entry = _check_forward(what, q, k, v)
    _build.check_inputs(what, q.device, o=o, lse=lse, do=do)
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    _build.require(o.shape == q.shape and do.shape == q.shape and o.dtype == q.dtype
                   and do.dtype == q.dtype, f"{what}: o and dO must have q's shape and dtype")
    _build.require(lse.dtype == torch.float32 and tuple(lse.shape) == (b, hq, sq),
                   f"{what}: lse must be float32 [B, Hq, Sq]")
    if entry == _WGMMA:
        _build.require(o.data_ptr() % 16 == 0 and do.data_ptr() % 16 == 0,
                       f"{what}: o and dO must be 16-byte aligned")
    scale = float(scale if scale is not None else dh**-0.5)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    fn = getattr(_build.library("flash_attention"), _BACKWARD_ENTRY[entry])
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                    do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
                    b, sq, sk, hq, hkv, dh, scale, int(bool(causal)), int(window),
                    _build.stream(q.device)), what)
    backward_launches += 1
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """``forward_with_lse`` (the kernel; ``plain`` on the CPU) forward, ``backward`` (the
    kernels; ``plain_backward`` on the CPU) backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        ctx.mask = (causal, window, scale)
        if q.device.type == "cpu":
            o = plain(q, k, v, causal=causal, window=window, scale=scale)
            ctx.save_for_backward(q, k, v, o)
            return o
        o, lse = forward_with_lse(q, k, v, causal=causal, window=window, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, *lse = ctx.saved_tensors
        causal, window, scale = ctx.mask
        do = do.contiguous()
        cost = lambda: backward_cost(q, k, v, causal=causal, window=window)
        with _build.kernel_scope("flash_attention_backward", cost):
            if q.device.type == "cpu":
                grads = plain_backward(q, k, v, o, do, causal=causal, window=window, scale=scale)
            else:
                grads = backward(q, k, v, o, lse[0], do, causal=causal, window=window, scale=scale)
        return (*grads, None, None, None)
