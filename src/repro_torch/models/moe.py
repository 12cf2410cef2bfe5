"""Mixture-of-Experts FFN with top-k routing.

Counterpart of ``repro.models.moe``. Routing: softmax over the experts'
float32 logits, top-k, combine weights renormalised over the k chosen
(OLMoE/Qwen3 convention), and the Switch load-balancing aux loss. Tokens
are routed in groups of ``group_size``; an expert takes at most
``expert_capacity`` assignments of a group, ranked token-major (token t's
j-th choice before token t+1's), and the assignments past it are dropped
(they contribute zero). Two dispatches, one result:

  * ``dispatch="einsum"`` -- one-hot dispatch and combine masks [T, E, C]
    (Switch/Mesh-TF style), the reference's default;
  * ``dispatch="sort"``   -- assignments sorted by expert (stably, so in
    token-major order within an expert), scattered into the [E, C, D]
    buffers by rank and combined by an indexed add.

Each dispatch runs four device-timed stages (``core.tracing.stages``, forward
and backward): ``moe.route``, ``moe.dispatch``, ``moe.experts`` and
``moe.combine``.

Where the reference vmaps over routing groups, the port carries the group
as a leading dim, and the expert FFN takes every group's capacity rows of an
expert as one block of rows: ``[E, G*C, D]``. Each expert product is one
``ops.moe_gmm`` call, so on CUDA it runs the hand-written grouped-matmul
kernel. Both dispatches fill an expert's block of a group from its first row,
so they hand the kernel ``live`` [E, G] = min(assignments, C): the rows past
it are zero, and the kernel neither reads them nor, for an expert that no
token chose, its weights.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.core import tracing
from repro_torch.kernels import ops
from repro_torch.models.common import ParamSpec
from repro_torch.models.layers import swiglu
from repro_torch.sharding.constraints import grad_placed, shard_as, unshard


def one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``F.one_hot(idx, n)`` in ``dtype``, as one comparison: ``F.one_hot`` takes
    other ATen ops on ``meta`` tensors than on the CPU and the card, and the
    dry-run's counts would differ."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def param_template(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    t = {
        "router": ParamSpec((d, e), ("embed", None), dtype="float32"),
        "w_gate": ParamSpec((e, d, f), ("experts", "embed", "ffn")),
        "w_up": ParamSpec((e, d, f), ("experts", "embed", "ffn")),
        "w_down": ParamSpec((e, f, d), ("experts", "ffn", "embed")),
    }
    if cfg.shared_expert_d_ff:
        fs = cfg.shared_expert_d_ff
        t["shared_gate"] = ParamSpec((d, fs), ("embed", "ffn"))
        t["shared_up"] = ParamSpec((d, fs), ("embed", "ffn"))
        t["shared_down"] = ParamSpec((fs, d), ("ffn", "embed"))
    return t


def expert_capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    """Assignments an expert takes per group: ceil(factor * T * k / E), rounded
    up to a multiple of 8 and at least k."""
    cap = int(math.ceil(cfg.moe_capacity_factor * tokens_per_group * cfg.experts_per_token
                        / cfg.num_experts))
    return max(cfg.experts_per_token, ((cap + 7) // 8) * 8)


def _route(x: torch.Tensor, router: torch.Tensor, k: int):
    """x [..., T, D] -> (expert_idx [..., T, k] int64, combine_w [..., T, k] f32, aux [...] f32).

    The router product is float32 (no TF32 on the card: the caller keeps
    ``torch.backends.cuda.matmul.allow_tf32`` off, its default)."""
    logits = x.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(probs, k, dim=-1)
    top_w = top_w / torch.clamp(top_w.sum(dim=-1, keepdim=True), min=1e-9)
    e = router.shape[1]
    density = one_hot(top_i, e, torch.float32).sum(dim=-2).mean(dim=-2)  # [..., E]
    aux = e * (density * probs.mean(dim=-2)).sum(dim=-1)
    return top_i, top_w, aux


def _expert_ffn(xe: torch.Tensor, p: Dict[str, torch.Tensor], live: torch.Tensor) -> torch.Tensor:
    """xe [E, R, D] -> [E, R, D], per-expert SwiGLU; the three products on ``ops.moe_gmm``.
    The down product's rows past ``live`` are silu(0) * 0 = 0 as well."""
    g = ops.moe_gmm(xe, p["w_gate"], live)
    u = ops.moe_gmm(xe, p["w_up"], live)
    return ops.moe_gmm(F.silu(g) * u, p["w_down"], live)


class _GroupsFirst(torch.autograd.Function):
    """[E, G*C, D] -> [G, E, C, D], contiguous. Its gradient is made contiguous before
    the reshape back: on a DTensor under autograd, DTensor takes the reshape of a
    transposed gradient for a view that the local shard's strides do not allow (ROADMAP
    C's table of DTensor faults). A reshape rather than a split along the rows keeps a
    row-sharded DTensor sharded, over G."""

    @staticmethod
    def forward(ctx, y, g):
        e, rows, d = y.shape
        ctx.shape = y.shape
        return y.reshape(e, g, rows // g, d).transpose(0, 1).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return grad.transpose(0, 1).contiguous().reshape(ctx.shape), None


def _groups_ffn(xe: torch.Tensor, p: Dict[str, torch.Tensor], counts: torch.Tensor) -> torch.Tensor:
    """xe [G, E, C, D] -> [G, E, C, D]: one expert FFN over all groups' rows; ``counts``
    [G, E] the assignments routed to each expert of each group (kept or not). G is the
    outer factor of the rows [E, G*C, D], so rows sharded over G stay sharded, with
    ``live`` [E, G] beside them (``ops.moe_gmm``'s row role)."""
    g, e, c, d = xe.shape
    # contiguous before the reshape: on an expert-sharded DTensor under autograd, DTensor
    # takes the reshape for a view that the local shard's strides do not allow
    rows = xe.transpose(0, 1).contiguous().reshape(e, g * c, d)
    live = counts.clamp(max=c).transpose(0, 1).to(torch.int32).contiguous()  # [E, G]
    return _GroupsFirst.apply(_expert_ffn(rows, p, live), g)


def _dispatch_einsum(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, w_gate: torch.Tensor,
                     cap: int):
    """The one-hot dispatch of x [G, T, D] by ``_route``'s idx and w ->
    (xe [G, E, C, D], combine [G, T, E, C] float32, counts [G, E, T*k])."""
    g, t, k = idx.shape
    e = w_gate.shape[0]
    onehot_e = one_hot(idx, e, torch.int32)                            # [G, T, k, E]
    # rank of each (token, choice) within its expert: exclusive cumsum, token-major.
    # The scan runs along the last dim ([G, E, T*k]): on CUDA a scan over an
    # outer dim with E = 64 columns took ~1.5 ms per layer at T = 1024.
    counts = torch.cumsum(unshard(onehot_e.reshape(g, t * k, e).transpose(1, 2).contiguous(), -1),
                          dim=-1, dtype=torch.int32)
    rank = ((counts.transpose(1, 2).reshape(g, t, k, e) - 1) * onehot_e).sum(dim=-1)  # [G, T, k]
    onehot_c = (rank[..., None] == torch.arange(cap, device=x.device)).float()  # 0: dropped
    onehot_e = onehot_e.float()
    dispatch = torch.einsum("gtke,gtkc->gtec", onehot_e, onehot_c)
    # the reference's einsum("tke,tkc,tk->tec"), with w folded into the expert
    # one-hot first: no [T, k, E, C] intermediate
    combine = torch.einsum("gtke,gtkc->gtec", onehot_e * w[..., None], onehot_c)

    # each expert's rows are gathered where its weights are (a DTensor's experts sharded
    # as w_gate's); x's gradient, a Partial sum over those ranks, is reduced where it arrives
    dispatch = shard_as(dispatch.to(x.dtype), 2, w_gate, 0)
    return torch.einsum("gtec,gtd->gecd", dispatch, grad_placed(x)), combine, counts


def _moe_einsum(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg: ModelConfig, cap: int):
    """Capacity one-hot dispatch. x [G, T, D] -> (y [G, T, D], aux [G])."""
    run = tracing.stages()
    idx, w, aux = run("moe.route", _route, x, p["router"], cfg.experts_per_token)
    xe, combine, counts = run("moe.dispatch", _dispatch_einsum, x, idx, w, p["w_gate"], cap)
    # expert-sharded outputs are gathered before the combine contracts E (torch 2.11's
    # DTensor cannot flatten the sharded E into the product's rows)
    ye = run("moe.experts", lambda xe, n: unshard(_groups_ffn(xe, p, n), 1), xe, counts[..., -1])
    y = run("moe.combine", lambda c, ye: torch.einsum("gtec,gecd->gtd", c.to(ye.dtype), ye),
            combine, ye, last=True)
    return y, aux


def _dispatch_sort(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, e: int, cap: int):
    """The sorted scatter of x [G, T, D] by ``_route``'s idx and w -> (xe [G, E, C, D],
    counts [G, E], and the kept assignments' group, slot, token and weight)."""
    g, t, k = idx.shape
    d = x.shape[-1]
    flat_e = idx.reshape(g, t * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se, sw = flat_e.gather(1, order), w.reshape(g, t * k).gather(1, order)
    stok = order // k                                                 # token of each assignment
    counts = one_hot(flat_e, e, torch.int64).sum(dim=1)               # [G, E]
    starts = torch.cumsum(counts, dim=-1) - counts
    rank = torch.arange(t * k, device=x.device) - starts.gather(1, se)
    keep = rank < cap

    gi = torch.arange(g, device=x.device)[:, None].expand(g, t * k)
    kg, ks, kt = gi[keep], (se * cap + rank)[keep], stok[keep]        # kept: group, slot, token
    xe = torch.zeros((g, e * cap, d), dtype=x.dtype, device=x.device)
    xe[kg, ks] = x[kg, kt]
    return xe.reshape(g, e, cap, d), counts, kg, ks, kt, sw[keep]


def _combine_sort(ye: torch.Tensor, kg, ks, kt, kw: torch.Tensor, t: int) -> torch.Tensor:
    """ye [G, E, C, D] back to tokens: y [G, T, D], each kept assignment's row times its
    weight, added at its token."""
    g, e, cap, d = ye.shape
    contrib = ye.reshape(g, e * cap, d)[kg, ks] * kw[:, None].to(ye.dtype)
    y = torch.zeros((g, t, d), dtype=ye.dtype, device=ye.device)
    y.index_put_((kg, kt), contrib, accumulate=True)
    return y


def _moe_sort(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg: ModelConfig, cap: int):
    """Sort-based scatter dispatch. x [G, T, D] -> (y [G, T, D], aux [G]).

    Assignments [G, T*k] are sorted by expert id (stably); rank-in-expert is
    the sorted position minus the expert's start offset. Kept assignments
    are scattered into [G, E*C, D]; dropped ones are written nowhere.
    """
    run = tracing.stages()
    idx, w, aux = run("moe.route", _route, x, p["router"], cfg.experts_per_token)
    xe, counts, kg, ks, kt, kw = run("moe.dispatch", _dispatch_sort, x, idx, w, cfg.num_experts, cap)
    ye = run("moe.experts", _groups_ffn, xe, p, counts)
    y = run("moe.combine", _combine_sort, ye, kg, ks, kt, kw, x.shape[1], last=True)
    return y, aux


def apply_moe(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg: ModelConfig, *,
              dispatch: str = "einsum", group_size: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN over x [..., S, D]; returns (y of x's shape, aux loss: mean over groups).

    Tokens are routed in groups of ``group_size`` (capacity is per group);
    a token count above it must be a multiple of it, as in the reference.
    """
    shape = x.shape
    d = shape[-1]
    xt = x.reshape(-1, d)
    t = xt.shape[0]
    gs = min(group_size, t)
    if t % gs:
        raise ValueError(f"tokens {t} not divisible by moe group {gs}")
    cap = expert_capacity(cfg, gs)
    xg = xt.reshape(t // gs, gs, d)

    fn = _moe_sort if dispatch == "sort" else _moe_einsum
    yg, aux = fn(xg, p, cfg, cap)

    if cfg.shared_expert_d_ff:
        yg = yg + swiglu(xg, p["shared_gate"], p["shared_up"], p["shared_down"])
    return yg.reshape(shape), aux.mean()
