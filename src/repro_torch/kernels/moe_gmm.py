"""Grouped per-expert matmul: the CUDA kernel ``csrc/moe_gmm.cu`` and its plain version.

Counterpart of ``repro.kernels.moe_gmm``: ``out[e] = xe[e] @ we[e]`` for
xe [E, C, D] and we [E, D, F], accumulated in float32 and returned in xe's
dtype. ``moe_gmm`` launches the kernel on CUDA tensors and raises on
anything else; ``plain`` is the PyTorch version the CPU path and the tests
use.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

__all__ = ["moe_gmm", "plain", "launches"]

launches = 0  # kernel launches since the last reset (see ``ops.reset_launch_counts``)

_ENTRY = {torch.float32: "moe_gmm_f32", torch.bfloat16: "moe_gmm_bf16"}


def plain(xe: torch.Tensor, we: torch.Tensor) -> torch.Tensor:
    """The kernel's function in PyTorch: a float32 einsum, cast to xe's dtype."""
    return torch.einsum("ecd,edf->ecf", xe.float(), we.float()).to(xe.dtype)


def moe_gmm(xe: torch.Tensor, we: torch.Tensor) -> torch.Tensor:
    """xe [E, C, D], we [E, D, F] of xe's dtype -> [E, C, F] in xe's dtype."""
    global launches
    _build.check_inputs("moe_gmm", xe.device, xe=xe, we=we)
    _build.require(xe.dtype in _ENTRY, f"moe_gmm: dtype {xe.dtype} not supported")
    _build.require(we.dtype == xe.dtype, "moe_gmm: we must have xe's dtype")
    _build.require(xe.dim() == 3 and we.dim() == 3, "moe_gmm: xe [E,C,D], we [E,D,F]")
    e, c, d = xe.shape
    f = we.shape[2]
    _build.require(tuple(we.shape[:2]) == (e, d), "moe_gmm: we's [E, D] disagrees with xe")
    _build.require(e <= 65535 and max(c, d, f) < 2**31, "moe_gmm: too many experts or rows")
    out = torch.empty((e, c, f), dtype=xe.dtype, device=xe.device)
    fn = getattr(_build.library("moe_gmm"), _ENTRY[xe.dtype])
    _build.check(fn(xe.data_ptr(), we.data_ptr(), out.data_ptr(), e, c, d, f,
                    _build.stream(xe.device)), "moe_gmm")
    launches += 1
    return out
