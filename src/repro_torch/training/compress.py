"""int8 error-feedback gradient compression.

Counterpart of ``repro.training.compress``: symmetric per-tensor int8 with
a float32 scale, and an error-feedback residual that carries each step's
quantisation error into the next step's gradient, so the time-averaged
gradient is unbiased (Karimireddy et al., 2019). ``torch.round`` rounds
half to even, as ``jnp.round`` does, so both packages give the same int8
bytes.

``compress_psum`` is the int8 all-reduce over a process group: every
replica quantizes against the largest of the replicas' scales, the int8
payload is summed as int32, and the mean is dequantized. Its residual is
the error of what was sent, ``corrected - dequantize(q_shared, scale_max)``.
The reference's (``repro.training.compress.compress_psum``) keeps the error
against the replica's own scale, so whenever the scales differ the error
of the shared quantization is lost for good. Like the reference's, it is
not wired into the train step.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.models.common import tree_items, tree_map, tree_map_with_path


class CompressedState(NamedTuple):
    """Error-feedback residual tree (the gradients' structure, float32)."""

    residual: Any


def init_residual(params) -> CompressedState:
    return CompressedState(residual=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params))


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns (q int8, scale float32)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max() / 127.0, min=1e-30)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_with_feedback(g: torch.Tensor, residual: torch.Tensor):
    """Quantize g + residual; return (q, scale, new_residual)."""
    corrected = g.float() + residual
    q, scale = quantize(corrected)
    return q, scale, corrected - dequantize(q, scale)


def tree_compress_with_feedback(grads, state: CompressedState):
    """Error-feedback int8 compression leaf by leaf: (the dequantized gradient
    tree, the new ``CompressedState``). The int8 round trip is what a link
    between replicas would carry."""
    res = dict(tree_items(state.residual))
    outs = {path: compress_with_feedback(g, res[path]) for path, g in tree_items(grads)}
    dq = tree_map_with_path(lambda path, _: dequantize(*outs[path][:2]), grads)
    new_res = tree_map_with_path(lambda path, _: outs[path][2], grads)
    return dq, CompressedState(residual=new_res)


def compress_psum(g: torch.Tensor, residual: torch.Tensor,
                  group: Optional[dist.ProcessGroup] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 all-reduce of this rank's ``g`` over ``group`` (the
    default group if None): (the mean over the group's ranks, float32; the new
    residual). The scale is the max of the replicas' (``all_reduce(MAX)``), the
    payload an int32 ``all_reduce(SUM)`` of ``clamp(round(corrected /
    scale_max), -127, 127)``, the mean ``summed * scale_max / n``."""
    corrected = g.float() + residual
    _, scale = quantize(corrected)
    scale_max = scale.clone()
    dist.all_reduce(scale_max, op=dist.ReduceOp.MAX, group=group)
    q_shared = torch.clamp(torch.round(corrected / scale_max), -127, 127).to(torch.int32)
    new_residual = corrected - dequantize(q_shared, scale_max)
    summed = q_shared.clone()
    dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
    n = torch.tensor(float(dist.get_world_size(group)), dtype=torch.float32, device=g.device)
    return summed.float() * scale_max / n, new_residual
