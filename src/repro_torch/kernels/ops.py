"""Kernel entry points the model calls: one per kernel.

A tensor on the CPU goes to the kernel's plain PyTorch version. A CUDA
tensor goes to the hand-written kernel, which launches or raises; there is
no fallback from one to the other. Each kernel module counts its launches.

Under autograd (grad mode on and an input that requires grad) a CUDA tensor
goes to the kernel's ``torch.autograd.Function`` where it has one
(``rmsnorm``, ``flash_attention``: the kernel forward, the gradient formula
backward). ``decode_attention``, ``moe_gmm`` and ``ssd`` have no backward yet
and raise ``NotImplementedError`` there, rather than return an output that
no gradient passes through. Serving runs under ``torch.inference_mode()``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import moe_gmm as _gmm
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels import ssd as _ssd

_KERNELS = {"rmsnorm": _rms, "flash_attention": _flash, "decode_attention": _decode,
            "moe_gmm": _gmm, "ssd": _ssd}


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _no_backward(name: str, *tensors) -> None:
    if _wants_grad(*tensors):
        raise NotImplementedError(
            f"{name}: the CUDA kernel has no backward yet; it runs under "
            f"torch.no_grad()/inference_mode() or on CPU tensors (its plain version)")


def rmsnorm(x, scale, *, eps: float = 1e-5):
    if x.device.type == "cpu":
        return _rms.plain(x, scale, eps)
    if _wants_grad(x, scale):
        return _rms.RMSNormFunction.apply(x, scale, eps)
    return _rms.rmsnorm(x, scale, eps)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: Optional[float] = None):
    if q.device.type == "cpu":
        return _flash.plain(q, k, v, causal=causal, window=window, scale=scale)
    if _wants_grad(q, k, v):
        return _flash.FlashAttentionFunction.apply(q, k, v, causal, window, scale)
    return _flash.flash_attention(q, k, v, causal=causal, window=window, scale=scale)


def decode_attention(q, k_cache, v_cache, slot_pos, cur_pos, *, window: int = 0,
                     scale: Optional[float] = None):
    if q.device.type == "cpu":
        return _decode.plain(q, k_cache, v_cache, slot_pos, cur_pos, window=window, scale=scale)
    _no_backward("decode_attention", q, k_cache, v_cache)
    return _decode.decode_attention(q, k_cache, v_cache, slot_pos, cur_pos, window=window,
                                    scale=scale)


def moe_gmm(xe, we, live=None):
    """``live`` int32 [E, G]: leading rows of each group's block that may be non-zero."""
    if xe.device.type == "cpu":
        return _gmm.plain(xe, we, live)
    _no_backward("moe_gmm", xe, we)
    return _gmm.moe_gmm(xe, we, live)


def ssd(x, a, b, c, *, chunk: int):
    """(y, final state); the chunk length is ``min(chunk, S)``, as in the Pallas kernel."""
    if x.device.type == "cpu":
        return _ssd.plain(x, a, b, c, min(chunk, x.shape[1]))
    _no_backward("ssd", x, a, b, c)
    return _ssd.ssd(x, a, b, c, chunk=chunk)


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return {name: mod.launches for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.launches = 0
