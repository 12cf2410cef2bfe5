"""Opt-in activation sharding constraints.

Counterpart of ``repro.sharding.constraints``. Inside an
``activation_constraints(mesh, plan)`` context, ``shard_act(x, kind)``
redistributes a ``DTensor`` activation to the placements its kind names:

  * activations carry batch over the data axes;
  * the head / ffn / vocab dimension of intermediates carries the model
    axis (when divisible).

Outside the context, and on a plain tensor, ``shard_act`` is the identity,
so the unsharded model runs unchanged. The model calls it where the
reference does: ``layers.swiglu``, ``layers._xent_chunk``,
``transformer._qkv`` and ``transformer.block_full``.

``split_heads``, ``merge_heads`` and ``reduce_partial`` work around limits
of DTensor that XLA's partitioner does not have: an uneven unflatten of
heads (forward or backward), and a sharded bias added to a ``Partial``
product.

``place_head`` keeps the LM head's product batch-sharded where DTensor would
trade that for a smaller collective. ``local_span``, ``take_rows`` and ``take_last`` are
helpers of the model's own code on shards: an embedding lookup and a gather
along the vocabulary run on local shards, as the plain path runs them, where DTensor's own
sharding rules for ``index``/``gather`` and their gradients fail in some
torch versions. ``unshard(x, dim)`` is not a constraint of the reference:
it replicates a DTensor along one dim before a scan over it. DTensor
(torch 2.13) keeps a ``cumsum``'s input sharding on the scanned dim and
scans each shard alone, which gives every shard but the first the wrong
prefix: olmoe smoke's expert ranks on a batch-sharded (2, 1) mesh came out
wrong, its logits 0.08 off.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

from repro_torch.sharding.rules import Spec, mesh_axes, placements

_CTX: contextvars.ContextVar = contextvars.ContextVar("activation_constraints", default=None)

KINDS = ("bsd", "bshd", "bsf", "bsv", "bd", "bhd", "bshp")


@contextlib.contextmanager
def activation_constraints(mesh, plan):
    """``mesh`` a ``DeviceMesh`` or a stub with ``axis_names`` and a ``shape`` mapping."""
    token = _CTX.set({"mesh": mesh, "data": tuple(plan.data_axes),
                      "model": tuple(plan.tensor_axes)})
    try:
        yield
    finally:
        _CTX.reset(token)


def _axes_for(ctx, names: Tuple[str, ...], dim: int):
    """The mesh axes among ``names`` that shard a dim of size ``dim``: None unless
    their product is above 1 and divides it; one name alone, else a tuple."""
    sizes = mesh_axes(ctx["mesh"])
    names = tuple(a for a in names if a in sizes)
    if not names:
        return None
    prod = math.prod(sizes[a] for a in names)
    if prod <= 1 or dim % prod != 0:
        return None
    return names if len(names) > 1 else names[0]


def act_spec(shape: Tuple[int, ...], kind: str) -> Optional[Spec]:
    """The spec ``shard_act`` gives an activation of ``shape`` (entries as the
    reference's ``PartitionSpec``), or None outside the context or for an
    unknown kind. Kinds:
    bsd   [B,S,D]    batch->data
    bshd  [B,S,H,dh] batch->data, heads->model
    bsf   [B,S,F]    batch->data, features->model
    bsv   [B,S,V]    batch->data, vocab->model
    bd    [B,D]      batch->data
    bhd   [B,H,dh]   batch->data, heads->model
    bshp  [B,S,H,P]  batch->data, head_dim->model (SSD inputs: SSM head counts
                     rarely divide the model axis, P does)
    """
    ctx = _CTX.get()
    if ctx is None or kind not in KINDS:
        return None
    d, m = ctx["data"], ctx["model"]
    batch = _axes_for(ctx, d, shape[0])
    if kind in ("bsd", "bd"):
        return (batch,)
    if kind == "bshd":
        return (batch, None, _axes_for(ctx, m, shape[2]), None)
    if kind in ("bsf", "bsv"):
        return (batch, None, _axes_for(ctx, m, shape[2]))
    if kind == "bhd":
        return (batch, _axes_for(ctx, m, shape[1]))
    return (batch, None, None, _axes_for(ctx, m, shape[3]))   # bshp


def shard_act(x: torch.Tensor, kind: str) -> torch.Tensor:
    """Constrain one activation: ``x`` redistributed to ``act_spec``'s placements
    on the context's mesh, if ``x`` is a DTensor inside the context."""
    if not isinstance(x, DTensor):
        return x
    spec = act_spec(tuple(x.shape), kind)
    if spec is None:
        return x
    return x.redistribute(x.device_mesh, placements(spec, x.dim(), _CTX.get()["mesh"]))


def unshard(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with any sharding of ``dim`` replicated (a DTensor), or as it is."""
    if not isinstance(x, DTensor):
        return x
    dim %= x.dim()
    if Shard(dim) not in x.placements:
        return x
    return x.redistribute(x.device_mesh, tuple(Replicate() if p == Shard(dim) else p
                                                for p in x.placements))


def shard_as(x: torch.Tensor, dim: int, like: torch.Tensor, like_dim: int) -> torch.Tensor:
    """``x`` with ``dim`` sharded over the mesh dimensions where ``like`` shards
    ``like_dim`` and ``x`` is replicated, if together they divide it (a local slice:
    no collective), or as it is. The MoE dispatch's experts go where the expert
    weights are, as the reference's SPMD partitioner places that einsum."""
    if not isinstance(x, DTensor) or not isinstance(like, DTensor):
        return x
    dims = [i for i, (p, q) in enumerate(zip(like.placements, x.placements))
            if p == Shard(like_dim) and q == Replicate()]
    ways = math.prod(x.device_mesh.size(i) for i in dims)
    if not dims or x.shape[dim] % ways:
        return x
    return x.redistribute(x.device_mesh, tuple(Shard(dim % x.dim()) if i in dims else q
                                                for i, q in enumerate(x.placements)))


def argmax_last(x: torch.Tensor) -> torch.Tensor:
    """``torch.argmax(x, dim=-1)``; on a DTensor sharded along the last dim (vocab-sharded
    logits) that dim is gathered first. DTensor's own argmax there (torch 2.13)
    all-gathers each rank's (max, index) along the reduced dim, and fails where the
    rank holds one row ("shape '[1, 16, 16, 1]' is invalid for input of size 16": a
    batch of 2 on the 2 x 16 x 16 mesh, sharded over "pod" alone)."""
    return torch.argmax(unshard(x, -1), dim=-1)


def split_heads(x: torch.Tensor, heads: int, head_dim: int) -> torch.Tensor:
    """``x`` [..., heads * head_dim] -> [..., heads, head_dim].

    A DTensor whose last dim is sharded over mesh dimensions whose product does
    not divide ``heads`` is first replicated along it (an all-gather over those
    dimensions): DTensor cannot unflatten a dim unevenly, where XLA's partitioner
    can (granite-8b's 8 KV heads on a 16-way model axis)."""
    if isinstance(x, DTensor):
        last = x.dim() - 1
        ways = math.prod(x.device_mesh.size(i) for i, p in enumerate(x.placements)
                         if p == Shard(last))
        if heads % ways:
            x = unshard(x, last)
    return x.reshape(*x.shape[:-1], heads, head_dim)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """``x`` [..., heads, head_dim] -> [..., heads * head_dim].

    A DTensor whose last two dims are not sharded is reshaped on its local
    shard, so its gradient comes back placed as ``x`` is: DTensor would
    otherwise unflatten a gradient sharded over more ways than there are heads
    (hymba-1.5b's 25 heads on a 16-way model axis, in a training step)."""
    if isinstance(x, DTensor) and not any(isinstance(p, Shard) and p.dim >= x.dim() - 2
                                          for p in x.placements) \
            and not any(isinstance(p, Partial) for p in x.placements):
        local = x.to_local()
        return DTensor.from_local(local.reshape(*local.shape[:-2], -1), x.device_mesh,
                                  x.placements, run_check=False)
    return x.reshape(*x.shape[:-2], -1)


class _GradPlaced(torch.autograd.Function):
    """The identity; its backward places the gradient as the input is placed (a
    ``Partial`` input's gradient replicated)."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = tuple(Replicate() if isinstance(p, Partial) else p for p in x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g


def grad_placed(x: torch.Tensor) -> torch.Tensor:
    """``x``, whose gradient under autograd is redistributed to ``x``'s own
    placements where it arrives (a ``Partial`` sum reduced), before it meets
    another: torch 2.11's DTensor cannot add a ``Partial`` gradient to a sharded
    one ("redistribute from S(1) to P(sum)": hymba-1.5b's tied embedding in
    ``train_4k``)."""
    if isinstance(x, DTensor) and x.requires_grad and torch.is_grad_enabled():
        return _GradPlaced.apply(x)
    return x


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """``x`` with every ``Partial`` placement summed to ``Replicate()`` (an
    all-reduce), or as it is. Before a bias add: torch 2.11's DTensor cannot add a
    sharded bias to a ``Partial`` product ("redistribute from S(0) to P(sum) not
    supported yet"; whisper-base smoke on a (2, 2) mesh)."""
    if not isinstance(x, DTensor) or not any(isinstance(p, Partial) for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, tuple(Replicate() if isinstance(p, Partial) else p
                                                for p in x.placements))


def local_span(t: DTensor, dim: int):
    """(offset, length) of this rank's shard of ``t`` along ``dim``, as DTensor lays
    it out: mesh dimensions that shard one tensor dim split it outermost first, and a
    dim that does not divide gives the last shards fewer (or no) rows."""
    shape, offset = compute_local_shape_and_global_offset(t.shape, t.device_mesh, t.placements)
    return offset[dim], shape[dim]


def place_head(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The LM head ``w`` [D, V] placed for the product ``x @ w`` with rows ``x``
    [..., D]: each mesh dimension that shards ``x``'s batch (dim 0) replicates ``w``
    (an all-gather: ZeRO-3's gather of a weight), and each that shards neither splits
    ``w``'s vocabulary, so the logits keep the batch's sharding and each model rank
    takes its span of the vocabulary (an uneven one where V does not divide).

    DTensor picks a product's placements by the bytes each choice moves, not the work
    it leaves on each rank: on hymba-1.5b's micro-batches of 64 sequences on 16 data
    ranks (``train_4k``, grad_accum 4) it all-gathered each rank's 4 rows rather than
    the tied 1600 x 32001 head sharded along its embed dim, and every data rank
    multiplied all 64 sequences by the whole vocabulary (1.15x the step's FLOPs of
    grad_accum 1)."""
    if not isinstance(w, DTensor) or not isinstance(x, DTensor):
        return w
    last = w.dim() - 1
    want = tuple(Replicate() if xp == Shard(0) else
                 Shard(last) if isinstance(xp, Replicate) and isinstance(wp, Replicate)
                 and w.device_mesh.size(i) > 1 else wp
                 for i, (xp, wp) in enumerate(zip(x.placements, w.placements)))
    return w if want == tuple(w.placements) else w.redistribute(w.device_mesh, want)


def take_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` along the last dim: ``idx`` [...] int64, one index a row.

    On a DTensor sharded along the last dim (vocab-sharded logits) or ``Partial``
    (logits of replicated rows times a head sharded along the contracted dim) the
    gather runs on local shards: a rank picks the indices in its span of the last
    dim and contributes 0 for the others, a ``Partial`` sum over those mesh
    dimensions, and a ``Partial`` input stays ``Partial`` (a gather is linear), its
    gradient replicated. DTensor's own ``gather`` (torch 2.13) yields a masked
    partial in both cases, and its reduction fails once the gathered dim is dropped
    ("too many indices for tensor of dimension 2")."""
    last = x.dim() - 1
    if not isinstance(x, DTensor) or not any(p == Shard(last) or isinstance(p, Partial)
                                             for p in x.placements):
        return torch.gather(x, -1, idx[..., None])[..., 0]
    mesh = x.device_mesh
    rows = tuple(p if isinstance(p, Shard) and p.dim < last else Replicate() for p in x.placements)
    keep = tuple(p if p == Shard(last) or isinstance(p, Partial) else r
                 for p, r in zip(x.placements, rows))
    idx = idx if isinstance(idx, DTensor) else DTensor.from_local(
        idx, mesh, (Replicate(),) * mesh.ndim, run_check=False)
    xl = x.redistribute(mesh, keep).to_local(grad_placements=tuple(
        Replicate() if isinstance(p, Partial) else p for p in keep))
    il = idx.redistribute(mesh, rows).to_local()
    off, n = local_span(x, last)
    il = il - off
    here = (il >= 0) & (il < n)
    got = torch.gather(xl, -1, il.clamp(0, n - 1)[..., None])[..., 0]
    got = torch.where(here, got, torch.zeros((), dtype=got.dtype, device=got.device))
    return DTensor.from_local(got, mesh, tuple(Partial() if p == Shard(last) else p
                                               for p in keep), run_check=False)


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``: rows of ``table`` [V, D] for integer ``idx`` [...] -> [..., D].

    On a DTensor table the lookup runs on local shards: a mesh dimension that
    shards the rows (vocab) gives each rank the indices in its span and 0 for
    the others (a ``Partial`` sum); one that shards the columns gives the
    output's last dim sharded if the indices are replicated there, and is
    gathered (ZeRO-3's all-gather of the table) if they are sharded, so that the
    lookup keeps the batch's sharding; one that replicates the table keeps the
    indices' sharding. Where the table is whole and the indices sharded, each
    rank's gradient of the table is its batch's share: a ``Partial`` sum. The
    local op is the plain path's ``table[idx]``, so its gradient is too. (torch
    2.11's DTensor fails on the gradient of ``table[idx]`` with batch-sharded
    indices: "Shard dim -1 ... must be normalized".)"""
    if not isinstance(table, DTensor):
        return table[idx]
    mesh = table.device_mesh
    idx = idx if isinstance(idx, DTensor) else DTensor.from_local(
        idx, mesh, (Replicate(),) * mesh.ndim, run_check=False)
    table_pl, grad_pl, idx_pl, out_pl = [], [], [], []
    for pt, pi in zip(table.placements, idx.placements):
        if pt == Shard(0):
            table_pl.append(pt)
            idx_pl.append(Replicate())
            out_pl.append(Partial())
        elif pt == Shard(1) and not isinstance(pi, Shard):
            table_pl.append(pt)
            idx_pl.append(Replicate())
            out_pl.append(Shard(idx.dim()))
        else:
            keep = isinstance(pi, Shard)
            table_pl.append(Replicate())
            idx_pl.append(pi if keep else Replicate())
            out_pl.append(pi if keep else Replicate())
        grad_pl.append(Partial() if table_pl[-1] == Replicate() and idx_pl[-1] != Replicate()
                       else table_pl[-1])
    tl = grad_placed(table).redistribute(mesh, tuple(table_pl)).to_local(
        grad_placements=tuple(grad_pl))
    il = idx.redistribute(mesh, tuple(idx_pl)).to_local()
    if Shard(0) in table.placements:
        off, n = local_span(table, 0)
        il = il - off
        here = (il >= 0) & (il < n)
        got = tl[il.clamp(0, n - 1)]
        got = torch.where(here[..., None], got, torch.zeros((), dtype=got.dtype, device=got.device))
    else:
        got = tl[il]
    return DTensor.from_local(got, mesh, tuple(out_pl), run_check=False)
