"""Grouped per-expert matmul: the CUDA kernels ``csrc/moe_gmm.cu`` and their plain version.

Counterpart of ``repro.kernels.moe_gmm``: ``out[e] = xe[e] @ we[e]`` for
xe [E, R, D] and we [E, D, F], accumulated in float32 and returned in xe's
dtype. The R rows of an expert are G groups of C rows, and the optional int32
``live`` [E, G] says how many leading rows of each group's block may be
non-zero (the routed assignments, at most the capacity): the rows past it are
neither read nor multiplied and come back as zero, and an expert with no live
row reads no weight. ``moe_gmm`` launches a kernel on CUDA tensors and raises
on anything else; ``plain`` is the PyTorch version the CPU path and the tests
use. On ``meta`` tensors ``moe_gmm`` returns an empty output of the kernel's
shape (the dry-run); ``cost`` is the work of one call.

``kernel_for`` picks the kernel by dtype: bf16 runs on the tensor cores
(``wgmma``, the rows of a block cut by ``tile_plan``), float32 on the CUDA
cores.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

__all__ = ["moe_gmm", "plain", "cost", "live_rows", "kernel_for", "tile_plan", "launches",
           "BLOCK_COLS", "MAX_BLOCK_ROWS"]

launches = 0  # kernel launches since the last reset (see ``ops.reset_launch_counts``)

BLOCK_COLS = 128      # wg::kBM: F columns per block of the tensor-core kernel
MAX_BLOCK_ROWS = 240  # the largest row tile: 3 products of 80 rows

_ENTRY = {torch.float32: "moe_gmm_f32", torch.bfloat16: "moe_gmm_bf16"}
# (rows up to, (rows per wgmma product, products per block)): the pairs the source
# instantiates, the smallest that holds R rows
_PLANS = ((8, (8, 1)), (16, (8, 2)), (80, (80, 1)), (160, (80, 2)))


def kernel_for(dtype: torch.dtype) -> str:
    """The C entry for xe's dtype: the tensor-core kernel for bf16, the CUDA-core
    kernel for float32."""
    return _ENTRY[dtype]


def tile_plan(rows: int) -> Tuple[int, int]:
    """(rows per ``wgmma`` product, products per block) of the bf16 kernel for an
    expert of ``rows`` rows: the smallest instantiated tile that holds them, else
    ``MAX_BLOCK_ROWS`` rows a block in several row tiles."""
    for most, plan in _PLANS:
        if rows <= most:
            return plan
    return 80, MAX_BLOCK_ROWS // 80


def live_rows(live: torch.Tensor, rows: int) -> torch.Tensor:
    """bool [E, R]: row r of group r // C may be non-zero (r % C < live[e, r // C])."""
    e, g = live.shape
    c = rows // g
    within = torch.arange(c, device=live.device)
    return (within[None, None, :] < live[:, :, None]).reshape(e, rows)


def plain(xe: torch.Tensor, we: torch.Tensor, live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in PyTorch: the rows past ``live`` zeroed, a float32
    einsum, cast to xe's dtype."""
    x = xe.float()
    if live is not None:
        x = x * live_rows(live, xe.shape[1])[..., None]
    return torch.einsum("ecd,edf->ecf", x, we.float()).to(xe.dtype)


def cost(xe: torch.Tensor, we: torch.Tensor, *, rows: Optional[int] = None,
         experts: Optional[int] = None) -> _build.Cost:
    """2·D·F operations a live row; the live rows of xe and the weights of the experts
    with a live row read once, every output row written once.

    ``rows`` (live rows over all experts) and ``experts`` (experts with one) depend
    on the routing; left out, every row and expert counts, which is all a shape says
    (``launch.hlo_counter`` counts so, on ``meta`` tensors and on the card alike)."""
    e, r, d = xe.shape
    f = we.shape[2]
    rows = e * r if rows is None else rows
    experts = e if experts is None else experts
    return _build.Cost(2.0 * rows * d * f, float((rows * d + experts * d * f + e * r * f)
                                                 * xe.element_size()))


def moe_gmm(xe: torch.Tensor, we: torch.Tensor, live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """xe [E, R, D], we [E, D, F] of xe's dtype, live int32 [E, G] with G | R or None
    -> [E, R, F] in xe's dtype."""
    global launches
    if xe.device.type == "meta":
        return torch.empty((xe.shape[0], xe.shape[1], we.shape[2]), dtype=xe.dtype, device="meta")
    _build.check_inputs("moe_gmm", xe.device, xe=xe, we=we,
                        **({} if live is None else {"live": live}))
    _build.require(xe.dtype in _ENTRY, f"moe_gmm: dtype {xe.dtype} not supported")
    _build.require(we.dtype == xe.dtype, "moe_gmm: we must have xe's dtype")
    _build.require(xe.dim() == 3 and we.dim() == 3, "moe_gmm: xe [E,R,D], we [E,D,F]")
    e, rows, d = xe.shape
    f = we.shape[2]
    _build.require(tuple(we.shape[:2]) == (e, d), "moe_gmm: we's [E, D] disagrees with xe")
    _build.require(e <= 65535 and max(rows, d, f) < 2**31, "moe_gmm: too many experts or rows")
    groups = 1
    if live is not None:
        _build.require(live.dtype == torch.int32 and live.dim() == 2 and live.shape[0] == e,
                       "moe_gmm: live must be int32 [E, G]")
        groups = live.shape[1]
        _build.require(groups > 0 and rows % groups == 0, "moe_gmm: G must divide the rows")
    out = torch.empty((e, rows, f), dtype=xe.dtype, device=xe.device)
    entry = kernel_for(xe.dtype)
    fn = getattr(_build.library("moe_gmm"), entry)
    args = [xe.data_ptr(), we.data_ptr(), None if live is None else live.data_ptr(),
            out.data_ptr(), e, rows, groups, d, f]
    if xe.dtype == torch.bfloat16:
        args += tile_plan(rows)
    _build.check(fn(*args, _build.stream(xe.device)), "moe_gmm")
    launches += 1
    return out
