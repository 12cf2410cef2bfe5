"""Row RMSNorm: the CUDA kernel ``csrc/rmsnorm.cu``, its plain version and its gradient.

Counterpart of ``repro.kernels.rmsnorm``. ``rmsnorm`` launches the kernel on
CUDA tensors and raises on anything else; ``plain`` is the PyTorch version
the CPU path and the tests use; on a ``meta`` tensor ``rmsnorm`` returns an
empty output of the kernel's shape (the dry-run), and ``cost`` is the work of
one call. ``RMSNormFunction`` is the kernel under
autograd: its forward is ``rmsnorm`` (``plain`` on a CPU tensor), its backward is
``backward``, the backward kernel of the same source (``plain_backward``, the
gradient formula in torch ops, on a CPU tensor; the reference has no backward
kernel: XLA differentiates its jnp norm). ``chunked_backward_reference`` is the
backward kernel's two passes in float32 PyTorch, for the tests.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.models.layers import rms_norm as plain

__all__ = ["rmsnorm", "plain", "cost", "plain_backward", "chunked_backward_reference",
           "backward_blocks", "backward", "backward_cost", "RMSNormFunction", "launches",
           "backward_launches", "BACKWARD_BLOCKS"]

launches = 0  # kernel launches since the last reset (see ``ops.reset_launch_counts``)
backward_launches = 0  # backward kernel launches since the last reset

_ENTRY = {torch.float32: "rmsnorm_f32", torch.bfloat16: "rmsnorm_bf16"}
_BACKWARD_ENTRY = {torch.float32: "rmsnorm_backward_f32", torch.bfloat16: "rmsnorm_backward_bf16"}
# the backward's first pass runs at most this many blocks (four an H100 SM), each over
# every BACKWARD_BLOCKS-th row; its float32 workspace holds a row of column sums a block
BACKWARD_BLOCKS = 528


def cost(x: torch.Tensor, scale: torch.Tensor) -> _build.Cost:
    """x and the output read and written once, the scale once; 4 operations an element."""
    numel = x.numel()
    return _build.Cost(4.0 * numel, float((2 * numel + scale.numel()) * x.element_size()))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x [..., D], scale [D] of x's dtype -> [..., D] in x's dtype."""
    global launches
    if x.device.type == "meta":
        return torch.empty_like(x)
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


def plain_backward(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
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


def backward_blocks(rows: int) -> int:
    """The first pass's blocks for ``rows`` rows (the workspace's rows): a function of
    the shape alone, so the sums repeat on any card."""
    return max(1, min(rows, BACKWARD_BLOCKS))


def chunked_backward_reference(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                               eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel's two passes in float32 PyTorch: (1) each row's Σx² and
    Σ gs·x in one reduction, dx = r·(gs − x̂·r·Σ gs·x / D), and block b's column sums
    of g·x̂ over rows b, b + blocks, ... into a [blocks, D] workspace; (2) dscale, the
    workspace summed over the blocks in order."""
    d = x.shape[-1]
    xf, gf = x.reshape(-1, d).float(), g.reshape(-1, d).float()
    rows = xf.shape[0]
    sf = scale.float()
    r = torch.rsqrt(xf.square().sum(-1, keepdim=True) / d + eps)
    mean = r * (gf * sf * xf).sum(-1, keepdim=True) / d
    xhat = xf * r
    dx = r * (gf * sf - xhat * mean)
    blocks = backward_blocks(rows)
    contrib = gf * xhat
    pad = (-rows) % blocks
    contrib = torch.cat([contrib, contrib.new_zeros((pad, d))])
    partial = contrib.reshape(-1, blocks, d).sum(0)              # [blocks, D]
    dscale = torch.zeros(d, device=x.device)
    for row in partial:
        dscale = dscale + row
    return dx.reshape(x.shape).to(x.dtype), dscale.to(scale.dtype)


def backward_cost(x: torch.Tensor, scale: torch.Tensor) -> _build.Cost:
    """8 operations an element (Σx², Σ gs·x, dx, g·x̂); x, g and dx once, scale read and
    dscale written once."""
    numel = x.numel()
    return _build.Cost(8.0 * numel, float((3 * numel + 2 * scale.numel()) * x.element_size()))


def backward(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
             eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel: x [..., D], scale [D], g of x's shape, all of x's dtype ->
    (dx, dscale)."""
    global backward_launches
    if x.device.type == "meta":
        return torch.empty_like(x), torch.empty_like(scale)
    what = "rmsnorm backward"
    _build.check_inputs(what, x.device, x=x, scale=scale, g=g)
    _build.require(x.dtype in _BACKWARD_ENTRY and scale.dtype == x.dtype and g.dtype == x.dtype,
                   f"{what}: x, scale and g must share a dtype of {list(_BACKWARD_ENTRY)}")
    d = x.shape[-1]
    _build.require(tuple(scale.shape) == (d,) and g.shape == x.shape,
                   f"{what}: scale [D] and g of x's shape")
    rows = x.numel() // d if d else 0
    _build.require(rows < 2**31 and 4 * d <= 227 * 1024, f"{what}: too many rows or columns")
    blocks = backward_blocks(rows)
    dx, dscale = torch.empty_like(x), torch.empty_like(scale)
    partial = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
    fn = getattr(_build.library("rmsnorm"), _BACKWARD_ENTRY[x.dtype])
    _build.check(fn(x.data_ptr(), scale.data_ptr(), g.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
                    partial.data_ptr(), rows, d, blocks, float(eps), _build.stream(x.device)), what)
    backward_launches += 1
    return dx, dscale


class RMSNormFunction(torch.autograd.Function):
    """``rmsnorm`` (the kernel; ``plain`` on the CPU) forward, ``backward`` (the kernel;
    ``plain_backward`` on the CPU) backward."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return plain(x, scale, eps) if x.device.type == "cpu" else rmsnorm(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        g = g.contiguous()
        with _build.kernel_scope("rmsnorm_backward", lambda: backward_cost(x, scale)):
            run = plain_backward if x.device.type == "cpu" else backward
            dx, dscale = run(x, scale, g, ctx.eps)
        return dx, dscale, None
