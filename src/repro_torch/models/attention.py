"""Attention: GQA plain versions and the decode-cache write.

Three plain implementations with one math, ported from
``repro.models.attention``:

  * ``naive_attention``   -- materialises [B, Hkv, G, Sq, Sk] scores; oracle.
  * ``chunked_attention`` -- flash-style online softmax over blocks; the
                             flash-attention kernel's plain version.
  * ``decode_attention``  -- one query token against a (ring) KV cache; the
                             decode-attention kernel's plain version.

Dtypes follow the JAX code step by step (scores are computed in the input
dtype and then widened to float32, probabilities are narrowed to V's dtype
before the PV product), so that a bf16 run rounds where the reference does.

Shape conventions:
  q        [B, Sq, Hq, dh]
  k, v     [B, Sk, Hkv, dh]      (Hq % Hkv == 0; G = Hq // Hkv)
  output   [B, Sq, Hq, dh]
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _gqa_split(q: torch.Tensor, num_kv: int) -> torch.Tensor:
    b, s, hq, dh = q.shape
    return q.reshape(b, s, num_kv, hq // num_kv, dh)


def _window_mask(qpos: torch.Tensor, kpos: torch.Tensor, window: int) -> Optional[torch.Tensor]:
    """Sliding-window mask; a window <= 0 means full attention (no mask)."""
    if window <= 0:
        return None
    return qpos - kpos < window


def promote(*ts: torch.Tensor):
    """Cast to one dtype as jnp promotion would (bf16 with f32 -> f32)."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return tuple(t.to(dt) for t in ts)


def naive_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, scale: Optional[float] = None) -> torch.Tensor:
    """Reference attention. Materialises [B, Hkv, G, Sq, Sk] scores."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else dh**-0.5
    qg, k = promote(_gqa_split(q, hkv), k)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() * scale
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    wm = _window_mask(qpos, kpos, window)
    if wm is not None:
        mask &= wm
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    p, v = promote(p.to(v.dtype), v)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v)
    return out.reshape(b, sq, hq, dh)


def chunked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      q_offset: int = 0, scale: Optional[float] = None,
                      q_block: int = 512, kv_block: int = 512) -> torch.Tensor:
    """Flash-style online-softmax attention over (q_block, kv_block) tiles.

    Sequences are padded to block multiples; padded KV columns are masked
    (``kpos < sk``) and padded query rows are sliced away.
    """
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else dh**-0.5
    q_block, kv_block = min(q_block, sq), min(kv_block, sk)
    sq_orig, sk_orig = sq, sk
    pad_q, pad_k = (-sq) % q_block, (-sk) % kv_block
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
        sq += pad_q
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
        sk += pad_k
    dev = q.device
    qg = _gqa_split(q, hkv)
    outs = []
    for q0 in range(0, sq, q_block):
        qblk = qg[:, q0:q0 + q_block]                       # [b, qb, k, g, dh]
        qpos = q_offset + q0 + torch.arange(q_block, device=dev)
        m = torch.full((b, hkv, g, q_block), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, hkv, g, q_block), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, hkv, g, q_block, dh), dtype=torch.float32, device=dev)
        for k0 in range(0, sk, kv_block):
            kblk, vblk = k[:, k0:k0 + kv_block], v[:, k0:k0 + kv_block]
            kpos = k0 + torch.arange(kv_block, device=dev)
            qb_, kb_ = promote(qblk, kblk)
            s = torch.einsum("bqkgd,bskd->bkgqs", qb_, kb_).float() * scale
            mask = (kpos[None, :] < sk_orig).expand(q_block, kv_block)
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
            wm = _window_mask(qpos[:, None], kpos[None, :], window)
            if wm is not None:
                mask = mask & wm
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pb, vb = promote(p.to(vblk.dtype), vblk)
            pv = torch.einsum("bkgqs,bskd->bkgqd", pb, vb)
            acc = acc * corr[..., None] + pv.float()
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]   # [b, k, g, qb, dh]
        outs.append(out.permute(0, 3, 1, 2, 4))             # [b, qb, k, g, dh]
    out = torch.cat(outs, dim=1).reshape(b, sq, hq, dh)[:, :sq_orig]
    return out.to(q.dtype)


def decode_attention(q, k_cache, v_cache, slot_pos, cur_pos, *, window: int = 0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-token attention against a (possibly ring-buffer) KV cache.

    q        [B, Hq, dh]       query for the new token
    k_cache  [B, S, Hkv, dh]   keys, already rotated at their write position
    v_cache  [B, S, Hkv, dh]
    slot_pos [B, S] int32      absolute position stored in each slot; -1 empty
    cur_pos  [B]    int32      position of the query token
    """
    b, hq, dh = q.shape
    hkv = k_cache.shape[2]
    scale = scale if scale is not None else dh**-0.5
    qg, kc = promote(q.reshape(b, hkv, hq // hkv, dh), k_cache)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, kc).float() * scale
    valid = (slot_pos >= 0) & (slot_pos <= cur_pos[:, None])
    if window > 0:
        valid &= cur_pos[:, None] - slot_pos < window
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    p, vc = promote(p.to(v_cache.dtype), v_cache)
    out = torch.einsum("bkgs,bskd->bkgd", p, vc)
    return out.reshape(b, hq, dh)


def cache_write_decode(cache_k, cache_v, slot_pos, k_new, v_new, pos, ring: bool) -> None:
    """Write one token [B, Hkv, dh] at position ``pos`` [B], in place.

    The slot is ``pos % S`` for a ring cache, else ``min(pos, S - 1)``: a
    request that runs past the cache overwrites the last slot, as the
    reference does. Writing in place moves only the touched rows, where the
    reference's functional update would return a new cache.
    """
    b, s = slot_pos.shape
    slot = (pos % s if ring else torch.clamp(pos, max=s - 1)).long()
    bidx = torch.arange(b, device=pos.device)
    cache_k[bidx, slot] = k_new.to(cache_k.dtype)
    cache_v[bidx, slot] = v_new.to(cache_v.dtype)
    slot_pos[bidx, slot] = pos.to(torch.int32)
