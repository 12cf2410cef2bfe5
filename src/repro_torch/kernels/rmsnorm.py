"""Row RMSNorm: the CUDA kernel ``csrc/rmsnorm.cu``, its plain version and its gradient.

Counterpart of ``repro.kernels.rmsnorm``. ``rmsnorm`` launches the kernel on
CUDA tensors and raises on anything else; ``plain`` is the PyTorch version
the CPU path and the tests use. ``RMSNormFunction`` is the kernel under
autograd: its forward launches ``rmsnorm``, its backward is
``rmsnorm_backward``, the gradient formula in torch ops (the reference has
no backward kernel: XLA differentiates its jnp norm).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.models.layers import rms_norm as plain

__all__ = ["rmsnorm", "plain", "rmsnorm_backward", "RMSNormFunction", "launches"]

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


def rmsnorm_backward(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                     eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradient of ``plain(x, scale, eps)`` for the output gradient ``g``:
    (dx in x's dtype, dscale in scale's dtype), statistics in float32.

    With r = rsqrt(mean(x²) + eps), x̂ = x·r and gs = g·scale:
    dx = r·(gs − x̂·mean(gs·x̂)) over the row, dscale = Σ_rows g·x̂.
    """
    xf = x.float()
    rstd = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    xhat = xf * rstd
    gf = g.float()
    gs = gf * scale.float()
    dx = rstd * (gs - xhat * (gs * xhat).mean(dim=-1, keepdim=True))
    dscale = (gf * xhat).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


class RMSNormFunction(torch.autograd.Function):
    """``rmsnorm`` (the kernel) forward, ``rmsnorm_backward`` backward."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_backward(x, scale, g.contiguous(), ctx.eps)
        return dx, dscale, None
