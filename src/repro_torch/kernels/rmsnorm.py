"""Row RMSNorm: the CUDA kernel ``csrc/rmsnorm.cu`` and its plain version.

Counterpart of ``repro.kernels.rmsnorm``. ``rmsnorm`` launches the kernel on
CUDA tensors and raises on anything else; ``plain`` is the PyTorch version
the CPU path and the tests use.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.models.layers import rms_norm as plain

__all__ = ["rmsnorm", "plain", "launches"]

launches = 0  # kernel launches since the last reset (see ``ops.reset_launch_counts``)

_ENTRY = {torch.float32: "rmsnorm_f32", torch.bfloat16: "rmsnorm_bf16"}


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x [..., D], scale [D] of x's dtype -> [..., D] in x's dtype."""
    global launches
    _build.check_inputs("rmsnorm", x.device, x=x, scale=scale)
    _build.require(x.dtype in _ENTRY, f"rmsnorm: dtype {x.dtype} not supported")
    _build.require(scale.dtype == x.dtype, "rmsnorm: scale must have x's dtype")
    d = x.shape[-1]
    _build.require(tuple(scale.shape) == (d,), f"rmsnorm: scale shape {tuple(scale.shape)} != ({d},)")
    rows = x.numel() // d if d else 0
    _build.require(rows < 2**31, "rmsnorm: too many rows")
    out = torch.empty_like(x)
    fn = getattr(_build.library("rmsnorm"), _ENTRY[x.dtype])
    _build.check(fn(x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d, float(eps),
                    _build.stream(x.device)), "rmsnorm")
    launches += 1
    return out
