"""Decode attention: the CUDA kernel ``csrc/decode_attention.cu`` and its plain version.

Counterpart of ``repro.kernels.decode_attention``: one query token per
sequence against a linear or ring KV cache, with slot-position masking. q
and the caches share a dtype, or q is float32 against a bf16 cache (a
float32 model's batched decode: the cache is bf16 as in the reference).
``decode_attention`` launches the kernel on CUDA tensors and raises on
anything else; ``plain`` is the PyTorch version the CPU path and the tests
use.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.models.attention import decode_attention as plain

__all__ = ["decode_attention", "plain", "launches", "MAX_GROUP", "MAX_HEAD_DIM"]

launches = 0  # kernel launches since the last reset (see ``ops.reset_launch_counts``)

MAX_GROUP = 16      # query heads per KV head (kMaxG in the source)
MAX_HEAD_DIM = 128  # kMaxDh in the source

# (q dtype, cache dtype) -> entry; the output has the cache's dtype
_ENTRY = {(torch.float32, torch.float32): "decode_attention_f32",
          (torch.bfloat16, torch.bfloat16): "decode_attention_bf16",
          (torch.float32, torch.bfloat16): "decode_attention_f32q_bf16kv"}


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     slot_pos: torch.Tensor, cur_pos: torch.Tensor, *, window: int = 0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q [B, Hq, dh]; caches [B, S, Hkv, dh] of q's dtype, or bf16 under a float32 q;
    slot_pos [B, S] and cur_pos [B] int32 -> [B, Hq, dh] in the caches' dtype."""
    global launches
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
    _build.require(hkv > 0 and hq % hkv == 0 and hq // hkv <= MAX_GROUP,
                   f"decode_attention: needs Hq % Hkv == 0 and Hq/Hkv <= {MAX_GROUP}")
    _build.require(0 < dh <= MAX_HEAD_DIM, f"decode_attention: head_dim must be <= {MAX_HEAD_DIM}")
    scale = float(scale if scale is not None else dh**-0.5)
    out = torch.empty(q.shape, dtype=k_cache.dtype, device=q.device)
    fn = getattr(_build.library("decode_attention"), entry)
    _build.check(fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), slot_pos.data_ptr(),
                    cur_pos.data_ptr(), out.data_ptr(), b, s, hq, hkv, dh, scale, int(window),
                    _build.stream(q.device)), "decode_attention")
    launches += 1
    return out
