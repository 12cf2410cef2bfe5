"""Logical-axis -> mesh-axis mapping.

Counterpart of ``repro.sharding.rules``. Parameter/cache templates carry
*logical* axis names (see ``repro_torch.models.common``). This module turns
them into concrete partition specs for a given mesh and ``ParallelPlan``,
then into ``torch.distributed.tensor`` placements on a ``DeviceMesh``.

Design rules (all enforced mechanically, so every (arch x shape x mesh)
cell is placed without hand-tuning):

  * Each logical axis has an ordered list of *candidate* mesh-axis groups.
  * A candidate is taken only if (a) none of its mesh axes is already used
    by another dim of the same tensor, and (b) the dim size is divisible by
    the product of the candidate's mesh-axis sizes. Otherwise we fall
    through to the next candidate, and finally to replication.
  * Candidates are filtered to axes present in the mesh, so one rule set
    serves both the single-pod ("data","model") and multi-pod
    ("pod","data","model") meshes.

The fallback-to-replication rule is what makes e.g. GQA caches with
kv_heads=8 on a 16-way model axis work: the ``cache_seq`` dim (which is
always a large power of two) takes the model axis instead.

A spec is a plain tuple with the entries of the reference's
``PartitionSpec``: per tensor dim, ``None`` (replicated), one mesh axis name,
or a tuple of names; trailing ``None``s stripped. ``placements`` turns it
into one ``Shard(dim)`` or ``Replicate()`` per mesh dimension, and the
``*_shardings`` functions return trees of ``MeshSharding`` (mesh, spec,
placements), the counterpart of ``NamedSharding``; ``place`` and
``place_tree`` put tensors where they say, as ``jax.device_put`` does. A mesh is a
``DeviceMesh`` or any object with ``axis_names`` and a ``shape`` mapping
(the reference's test stub), so the rules are exercised at production mesh
sizes on one CPU.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard, distribute_tensor

from repro_torch.config.parallel import ParallelPlan
from repro_torch.models.common import tree_items, tree_map, tree_map_with_path

AxisRules = Dict[Optional[str], Tuple[Tuple[str, ...], ...]]
Spec = Tuple[Any, ...]


@dataclass(frozen=True)
class MeshSharding:
    """Where one tensor lives on ``mesh``: its spec and, per mesh dimension,
    its placement. A leaf of the trees below."""

    mesh: Any
    spec: Spec
    placements: Tuple[Placement, ...]


def mesh_axes(mesh) -> Dict[str, int]:
    """Axis name -> size, in the mesh's order, of a ``DeviceMesh`` or of a
    stub with ``axis_names`` and a ``shape`` mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def default_rules(plan: ParallelPlan, kind: str = "train") -> AxisRules:
    """Build the logical->mesh candidate table.

    kind="train": ZeRO-3 FSDP (embed dim sharded over fsdp axes; weights are
    all-gathered per layer) x TP over the model axis.

    kind="serve": weights replicated over data axes (no per-step gather on
    the latency path), TP over the model axis; MoE expert FFN dims fall
    through to the data axes when the model axis is taken by the expert dim
    (keeps 235B-scale expert stacks under per-device HBM).
    """
    t = tuple(plan.tensor_axes)
    d = tuple(plan.data_axes)
    f = tuple(plan.fsdp_axes)
    e = tuple(plan.expert_axes)
    if kind == "train":
        embed = (f,) if plan.zero3 else ()
        ffn: Tuple[Tuple[str, ...], ...] = (t, f)
        vocab = (t,)
    else:  # serve
        embed = ()
        ffn = (t, d)
        vocab = (t,)
    return {
        None: (),
        "layers": (),
        "vocab": vocab,
        "embed": embed,
        "heads": (t,),
        "kv_heads": (t,),
        "ffn": ffn,
        "experts": (e,),
        "ssm_in": (t,),
        "ssm_state": (t,),
        "batch": (d,),
        "cache_seq": (t,),
        "window": (t,),
    }


def spec_for_axes(
    shape: Sequence[int],
    axes: Sequence[Optional[str]],
    rules: AxisRules,
    mesh,
) -> Spec:
    """Assign mesh axes to one tensor's dims (first-fit with divisibility)."""
    sizes = mesh_axes(mesh)
    used: set = set()
    entries: list = []
    for size, name in zip(shape, axes):
        assigned = None
        for cand in rules.get(name, ()):
            cand = tuple(a for a in cand if a in sizes and a not in used)
            if not cand:
                continue
            prod = int(np.prod([sizes[a] for a in cand]))
            if prod > 1 and size % prod == 0:
                assigned = cand if len(cand) > 1 else cand[0]
                used.update(cand)
                break
        entries.append(assigned)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def placements(spec: Spec, ndim: int, mesh) -> Tuple[Placement, ...]:
    """Per mesh dimension, ``Shard(d)`` if tensor dim d of an ``ndim``-dim
    tensor takes that mesh axis in ``spec``, else ``Replicate()``."""
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's {ndim} dims")
    names = list(mesh_axes(mesh))
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            out[names.index(a)] = Shard(dim)
    return tuple(out)


def _sharding(mesh, spec: Spec, ndim: int) -> MeshSharding:
    return MeshSharding(mesh, spec, placements(spec, ndim, mesh))


def _tree_shardings(template, rules: AxisRules, mesh):
    """ParamSpec tree -> MeshSharding tree."""
    return tree_map(
        lambda s: _sharding(mesh, spec_for_axes(s.shape, s.axes, rules, mesh), len(s.shape)),
        template)


def param_shardings(template, mesh, plan: ParallelPlan, kind: str = "train"):
    return _tree_shardings(template, default_rules(plan, kind), mesh)


def cache_shardings(cache_template, mesh, plan: ParallelPlan):
    return _tree_shardings(cache_template, default_rules(plan, "serve"), mesh)


def batch_spec(plan: ParallelPlan, mesh, batch_size: int) -> Spec:
    """Spec for [B, ...] host batches (tokens/targets/frames)."""
    sizes = mesh_axes(mesh)
    axes = tuple(a for a in plan.data_axes if a in sizes)
    if not axes:
        return ()
    prod = int(np.prod([sizes[a] for a in axes]))
    if batch_size % prod != 0:
        # shed trailing axes until divisible (e.g. global_batch=1 long-ctx)
        while axes:
            prod = int(np.prod([sizes[a] for a in axes]))
            if batch_size % prod == 0:
                break
            axes = axes[:-1]
        if not axes:
            return ()
    return (axes if len(axes) > 1 else axes[0],)


def batch_sharding(plan: ParallelPlan, mesh, batch_size: int) -> MeshSharding:
    return _sharding(mesh, batch_spec(plan, mesh, batch_size), 1)


def tree_batch_shardings(abstract_batch, plan: ParallelPlan, mesh):
    """Shard every leaf of a batch tree over the data axes (dim 0)."""
    return tree_map(lambda x: batch_sharding(plan, mesh, x.shape[0]), abstract_batch)


def replicated(mesh) -> MeshSharding:
    return _sharding(mesh, (), 0)


def place(x: torch.Tensor, sharding: MeshSharding) -> DTensor:
    """``x`` as a DTensor with ``sharding``'s placements: a plain tensor (the same
    whole value on every rank) is distributed, a DTensor placed otherwise is
    redistributed, one placed so is returned as it is."""
    if isinstance(x, DTensor):
        if x.device_mesh == sharding.mesh and tuple(x.placements) == sharding.placements:
            return x
        return x.redistribute(sharding.mesh, sharding.placements)
    return distribute_tensor(x, sharding.mesh, sharding.placements)


def place_tree(tree, shardings):
    """``place`` at every leaf of a tree of dicts and lists, by ``shardings``, a tree
    with the same paths."""
    by_path = dict(tree_items(shardings))
    return tree_map_with_path(lambda path, x: place(x, by_path[path]), tree)


def gather(x):
    """The whole value of a DTensor on every rank (a plain tensor as it is)."""
    return x.full_tensor() if isinstance(x, DTensor) else x
