"""Decode attention: the CUDA kernel ``csrc/decode_attention.cu`` and its plain version.

Counterpart of ``repro.kernels.decode_attention``: one query token per
sequence against a linear or ring KV cache, with slot-position masking. q
and the caches share a dtype, or q is float32 against a bf16 cache (a
float32 model's batched decode: the cache is bf16 as in the reference).
``decode_attention`` launches the kernel on CUDA tensors and raises on
anything else; ``plain`` is the PyTorch version the CPU path and the tests
use. On ``meta`` tensors ``decode_attention`` returns an empty output of the
kernel's shape (the dry-run); ``cost`` is the work of one call.

The kernel splits the KV axis (flash-decoding): ``split_plan`` cuts the S
slots into splits, one block per (KV head x up to ``ROWS_PER_BLOCK`` query
rows of its group, batch, split) computes the split's softmax statistics and
unnormalised output over its valid slots, and a combine step merges the
splits. ``split_reference`` is that computation in plain float32 PyTorch.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.config.parallel import H100_SXM
from repro_torch.kernels import _build
from repro_torch.models.attention import NEG_INF
from repro_torch.models.attention import decode_attention as plain

__all__ = ["decode_attention", "plain", "cost", "split_plan", "round_slots", "split_reference", "launches",
           "MAX_HEAD_DIM", "MAX_SPLIT_SLOTS", "ROWS_PER_BLOCK", "SPLIT_ALIGN"]

launches = 0  # kernel launches since the last reset (see ``ops.reset_launch_counts``)

MAX_HEAD_DIM = 128     # kMaxDh in the source; head_dim is also a power of two of 16-byte vectors
MAX_SPLIT_SLOTS = 512  # kMaxSplit: slots per split
ROWS_PER_BLOCK = 8     # query rows of a GQA group per block (larger groups in chunks)
SPLIT_ALIGN = 16       # slots per split are a multiple of this
SMS = H100_SXM.sm_count  # streaming multiprocessors of the card
BLOCKS_PER_SM = 2      # the grid split_plan aims for, where S allows

# (q dtype, cache dtype) -> entry; the output has the cache's dtype
_ENTRY = {(torch.float32, torch.float32): "decode_attention_f32",
          (torch.bfloat16, torch.bfloat16): "decode_attention_bf16",
          (torch.float32, torch.bfloat16): "decode_attention_f32q_bf16kv"}


def round_slots(g: int, elem_size: int, dh: int) -> int:
    """Slots one block loads at once (``MAX_SPLIT_SLOTS`` at most): the kernel's
    4 warps of 32 // lanes-per-slot lane groups, each holding ``loads_in_flight``
    slots' K and V, for groups of G query heads, a cache of ``elem_size``-byte
    elements and head_dim ``dh``."""
    rows = 1 if g <= 1 else 2 if g <= 2 else 4 if g <= 4 else ROWS_PER_BLOCK  # RMAX
    vec = 16 // elem_size                    # elements per 16-byte load
    in_flight = 4 if rows * vec >= 64 else 8  # loads_in_flight in the source
    return min(MAX_SPLIT_SLOTS, in_flight * 4 * (32 // (dh // vec)))


def split_plan(b: int, hkv: int, s: int, g: int, elem_size: int, dh: int) -> Tuple[int, int]:
    """(splits, slots per split) of an S-slot cache of ``elem_size``-byte elements
    for B rows, Hkv KV heads, groups of G query heads and head_dim ``dh``: slots per
    split a multiple of ``SPLIT_ALIGN`` and at most ``round_slots``, and enough
    splits that the grid has at least ``BLOCKS_PER_SM`` blocks per SM unless S
    runs out of ``SPLIT_ALIGN``-slot splits."""
    blocks = b * hkv * -(-g // ROWS_PER_BLOCK)        # blocks per split
    want = -(-BLOCKS_PER_SM * SMS // blocks)          # splits for the grid's target
    per = max(SPLIT_ALIGN, s // want // SPLIT_ALIGN * SPLIT_ALIGN)
    per = min(round_slots(g, elem_size, dh), per)
    return -(-s // per), per


def split_reference(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                    slot_pos: torch.Tensor, cur_pos: torch.Tensor, *, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """The kernel's computation in float32 PyTorch, on ``split_plan``'s splits: per
    split the max m, the probabilities relative to it (rounded to bf16 for a float32
    q on a bf16 cache), their sum l and the unnormalised P V; then the combine
    sum exp(m_i - M) acc_i / sum exp(m_i - M) l_i. A row with no valid slot gets the
    mean of V over all S slots, as in ``plain``. Same shapes and dtypes as ``plain``."""
    b, hq, dh = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else dh**-0.5
    kf, vf = k_cache.float(), v_cache.float()
    scores = torch.einsum("bkgd,bskd->bkgs", q.float().reshape(b, hkv, g, dh), kf) * scale
    valid = (slot_pos >= 0) & (slot_pos <= cur_pos[:, None])
    if window > 0:
        valid &= cur_pos[:, None] - slot_pos < window
    valid = valid[:, None, None, :].expand_as(scores)
    round_p = q.dtype != k_cache.dtype
    nsplit, per = split_plan(b, hkv, s, g, k_cache.element_size(), dh)
    ms, ls, accs = [], [], []
    for i in range(nsplit):
        sl = slice(i * per, min(s, (i + 1) * per))
        sc, ok = scores[..., sl], valid[..., sl]
        m = torch.where(ok, sc, NEG_INF).amax(dim=-1)
        p = torch.where(ok, torch.exp(sc - m[..., None]), 0.0)
        ls.append(p.sum(dim=-1))
        if round_p:
            p = p.to(k_cache.dtype).float()
        accs.append(torch.einsum("bkgs,bskd->bkgd", p, vf[:, sl]))
        ms.append(m)
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    w = torch.exp(m - m.amax(dim=0))
    out = (w[..., None] * acc).sum(dim=0) / torch.clamp((w * l).sum(dim=0), min=1e-30)[..., None]
    none = ~valid.any(dim=-1)                                   # [B, Hkv, G]
    mean = vf.mean(dim=1)[:, :, None, :].expand_as(out)        # [B, Hkv, G, dh]
    out = torch.where(none[..., None], mean, out)
    return out.reshape(b, hq, dh).to(k_cache.dtype)


def cost(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, slot_pos: torch.Tensor,
         cur_pos: torch.Tensor, *, valid: Optional[int] = None, rows_without: int = 0
         ) -> _build.Cost:
    """K and V read at the valid slots, a row without one reading V's S slots (its
    output is their mean), q read and the output written once, slot_pos and cur_pos
    read; QKᵀ and PV at 4·dh operations a valid slot and query head.

    ``valid`` (the (row, slot) pairs the masks allow) and ``rows_without`` depend on
    the data; left out, every slot of the cache counts, which is all a shape says
    (``launch.hlo_counter`` counts so, on ``meta`` tensors and on the card alike)."""
    b, hq, dh = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    valid = b * s if valid is None else valid
    csize = k_cache.element_size()
    nbytes = ((2 * valid + s * rows_without) * hkv * dh * csize
              + b * hq * dh * (q.element_size() + csize) + (b * s + b) * 4)
    return _build.Cost(4.0 * hq * dh * valid + hkv * dh * s * rows_without, float(nbytes))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     slot_pos: torch.Tensor, cur_pos: torch.Tensor, *, window: int = 0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q [B, Hq, dh]; caches [B, S, Hkv, dh] of q's dtype, or bf16 under a float32 q;
    slot_pos [B, S] and cur_pos [B] int32 -> [B, Hq, dh] in the caches' dtype."""
    global launches
    if q.device.type == "meta":
        return torch.empty(q.shape, dtype=k_cache.dtype, device="meta")
    _build.check_inputs("decode_attention", q.device, q=q, k_cache=k_cache, v_cache=v_cache,
                        slot_pos=slot_pos, cur_pos=cur_pos)
    entry = _ENTRY.get((q.dtype, k_cache.dtype))
    _build.require(entry is not None and v_cache.dtype == k_cache.dtype,
                   f"decode_attention: q {q.dtype} with caches {k_cache.dtype}/{v_cache.dtype} "
                   f"not supported")
    _build.require(slot_pos.dtype == torch.int32 and cur_pos.dtype == torch.int32,
                   "decode_attention: slot_pos and cur_pos must be int32")
    _build.require(q.dim() == 3 and k_cache.dim() == 4, "decode_attention: q [B,Hq,dh], cache [B,S,Hkv,dh]")
    b, hq, dh = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    _build.require(tuple(k_cache.shape) == (b, s, hkv, dh) and v_cache.shape == k_cache.shape,
                   "decode_attention: cache shapes disagree with q")
    _build.require(tuple(slot_pos.shape) == (b, s) and tuple(cur_pos.shape) == (b,),
                   "decode_attention: slot_pos [B,S], cur_pos [B]")
    vec = 16 // k_cache.element_size()   # cache elements per 16-byte load
    lanes = dh // vec
    _build.require(hkv > 0 and hq % hkv == 0, "decode_attention: needs Hq % Hkv == 0")
    _build.require(0 < dh <= MAX_HEAD_DIM and dh % vec == 0 and lanes & (lanes - 1) == 0,
                   f"decode_attention: head_dim must be <= {MAX_HEAD_DIM} and a power of two "
                   f"times {vec} elements (16 bytes)")
    _build.require(k_cache.data_ptr() % 16 == 0 and v_cache.data_ptr() % 16 == 0,
                   "decode_attention: caches must be 16-byte aligned")
    scale = float(scale if scale is not None else dh**-0.5)
    nsplit, per = split_plan(b, hkv, s, hq // hkv, k_cache.element_size(), dh)
    out = torch.empty(q.shape, dtype=k_cache.dtype, device=q.device)
    work = torch.empty(b * hq * nsplit * (dh + 2), dtype=torch.float32, device=q.device)
    fn = getattr(_build.library("decode_attention"), entry)
    _build.check(fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), slot_pos.data_ptr(),
                    cur_pos.data_ptr(), out.data_ptr(), work.data_ptr(), b, s, hq, hkv, dh, scale,
                    int(window), nsplit, per, _build.stream(q.device)), "decode_attention")
    launches += 1
    return out
