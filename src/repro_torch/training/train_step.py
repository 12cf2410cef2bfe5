"""Train-step builder: loss and gradients, accumulation, compression, AdamW.

Counterpart of ``repro.training.train_step`` on one device.
``build_train_step`` returns ``step(state, batch) -> (state, metrics)``:

  * the loss is ``api.train_loss`` under the plan's remat policy ("none",
    "full", "dots"), its gradients from ``torch.autograd.grad``;
  * with ``grad_accum`` > 1 the batch splits into micro-batches along its
    first axis and their gradients sum into float32 buffers, as the
    reference's ``lax.scan`` sums them (a ``.grad`` would accumulate in the
    parameter's dtype, bf16 at full width); loss and gradients are then
    divided by the count;
  * optional int8 error-feedback compression (``training.compress``);
  * then ``adamw_update``, which writes the parameters and moments in place.

The metrics are 0-dim tensors: ``loss`` (float32), ``grad_norm``, ``lr``.
Device-timed spans (``core.tracing``): ``train.step`` holds, for each micro-batch,
``train.forward``, ``train.backward`` and ``train.grad_sum`` (the sum into the
float32 buffers), then a ``train.grad_sum`` for the division and the gradients'
placement, and the optimizer's ``train.clip`` and ``train.adamw``.
``make_train_state_specs`` gives the state's abstract tree and its
placements on a ``DeviceMesh`` (``sharding.rules``), as the reference's gives
its shardings.

``jit_train_step`` is the reference's step sharded over a mesh, eager ("jit"
keeps the reference's name): it places the state by those placements (with
``zero3`` the embed dim is sharded over the fsdp axes: ZeRO-3) and the batch
over the data axes, runs the same step on DTensors under
``implicit_replication`` (the plain tensors the model builds from global
shapes are the same on every rank), and returns the metrics replicated.
Each gradient is redistributed to its parameter's placements (a ``Partial``
sum reduced, or reduce-scattered onto the shard), so AdamW updates each
DTensor leaf in place, on its shard. The step counter stays a host tensor,
as ``adamw_init`` makes it.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch
from torch.distributed.tensor import DTensor, Shard
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.config.parallel import ParallelPlan
from repro_torch.core import tracing
from repro_torch.models.common import tree_items, tree_map, tree_map_with_path
from repro_torch.models.model import ModelApi
from repro_torch.training import compress as compress_lib
from repro_torch.training.optimizer import (AdamWState, abstract_adamw_state, adamw_init,
                                            adamw_update)


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    residual: Any  # CompressedState or None (compression off)


def init_train_state(api: ModelApi, generator: torch.Generator, plan: ParallelPlan) -> TrainState:
    params = api.init_params(generator)
    residual = compress_lib.init_residual(params) if plan.compress_grads else None
    return TrainState(params=params, opt=adamw_init(params), residual=residual)


def abstract_train_state(api: ModelApi, plan: ParallelPlan) -> TrainState:
    """The state's structure, shapes and dtypes as ``meta`` tensors: a restore's
    template that allocates nothing."""
    params = api.abstract_params()
    residual = None
    if plan.compress_grads:
        residual = compress_lib.CompressedState(residual=tree_map(
            lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta"), params))
    return TrainState(params, abstract_adamw_state(params), residual)


def make_train_state_specs(api: ModelApi, plan: ParallelPlan, mesh) -> Tuple[TrainState, TrainState]:
    """(abstract_state, state_placements): the state on ``meta`` tensors, and a
    ``TrainState`` of ``sharding.rules.MeshSharding`` leaves on ``mesh``. The
    moments and the residual inherit the parameters' placements; ``step`` is
    replicated."""
    from repro_torch.sharding.rules import param_shardings, replicated, step_mesh

    mesh, plan = step_mesh(mesh, plan)
    abstract = abstract_train_state(api, plan)
    pshard = param_shardings(api.param_template, mesh, plan, kind="train")
    placements = TrainState(
        params=pshard,
        opt=AdamWState(step=replicated(mesh), mu=pshard, nu=pshard),
        residual=compress_lib.CompressedState(residual=pshard) if plan.compress_grads else None,
    )
    return abstract, placements


def _split_microbatches(batch: Dict[str, torch.Tensor], accum: int, plan: ParallelPlan):
    """The ``accum`` micro-batches of ``batch``: micro-batch ``i`` holds rows
    ``[i*n, (i+1)*n)`` of every leaf, ``n = B / accum``, as the reference's
    ``reshape(accum, n)`` gives them.

    A plain tensor is sliced. A DTensor leaf (the batch ``jit_train_step`` placed)
    gives micro-batches placed as a batch of ``n`` rows is (``rules.batch_sharding``),
    so each data rank holds ``n / data`` rows of each and the forward runs sharded.
    The leaf is first redistributed to those placements (an all-gather over the data
    axes that a batch of ``n`` sheds, else nothing); then one all-to-all over the data
    axes left moves each rank's rows to the rank whose share of its micro-batch they
    are: a rank sends and receives ``B / data`` rows a step. (DTensor's own slice of a
    sharded dim comes back replicated, and every data rank would run every micro-batch
    whole.)"""
    for key, x in batch.items():
        if x.shape[0] % accum:
            raise ValueError(f"batch {x.shape[0]} ({key}) not divisible by grad_accum {accum}")
    if accum == 1:
        return [dict(batch)]
    parts = {k: _microbatch_rows(x, accum, plan) for k, x in batch.items()}
    return [{k: p[i] for k, p in parts.items()} for i in range(accum)]


def _microbatch_rows(x: torch.Tensor, accum: int, plan: ParallelPlan):
    n = x.shape[0] // accum
    if not isinstance(x, DTensor):
        return [x[i * n:(i + 1) * n] for i in range(accum)]
    from torch.distributed._functional_collectives import AsyncCollectiveTensor, all_to_all_single

    from repro_torch.sharding.constraints import local_span
    from repro_torch.sharding.rules import batch_sharding

    mesh, rest = x.device_mesh, tuple(x.shape[1:])
    target = batch_sharding(plan, mesh, n).placements
    x = x.redistribute(mesh, target)
    dims = [k for k, p in enumerate(target) if p == Shard(0) and mesh.size(k) > 1]
    ways = math.prod(mesh.size(k) for k in dims)
    local, m = x.to_local(), n // ways
    if ways > 1:
        # rank s holds blocks s*accum + j (m rows each); block b belongs to micro-batch
        # b // ways, on rank b % ways. Sent grouped by rank, received in micro-batch order.
        s = local_span(x, 0)[0] // local.shape[0]
        dest = [(s * accum + j) % ways for j in range(accum)]
        order = sorted(range(accum), key=dest.__getitem__)
        src = [(i * ways + s) // accum for i in range(accum)]
        group = (mesh, dims[0]) if len(dims) == 1 else \
            mesh[tuple(mesh.mesh_dim_names[k] for k in dims)]._flatten()
        local = all_to_all_single(
            torch.cat([local[j * m:(j + 1) * m] for j in order]),
            [m * src.count(r) for r in range(ways)], [m * dest.count(r) for r in range(ways)],
            group)
        if isinstance(local, AsyncCollectiveTensor):
            local = local.wait()
    return [DTensor.from_local(local[i * m:(i + 1) * m], mesh, target, run_check=False,
                               shape=torch.Size((n, *rest)), stride=x.stride())
            for i in range(accum)]


def build_train_step(api: ModelApi, plan: ParallelPlan, *, lr: float = 3e-4,
                     weight_decay: float = 0.1, warmup_steps: int = 100,
                     total_steps: int = 10000) -> Callable:
    """``step(state, batch) -> (state, metrics)``; ``batch`` holds tensors on the
    parameters' device (``data.to_device``)."""

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with tracing.span("train.step", device=True):
            return _step(state, batch)

    def _step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        leaves = [p for _, p in tree_items(state.params)]
        for p in leaves:
            p.requires_grad_(True)
        accum = max(1, plan.grad_accum)
        loss_sum, acc = None, None
        for mb in _split_microbatches(batch, accum, plan):
            with tracing.span("train.forward", device=True):
                loss = api.train_loss(state.params, mb, remat=plan.remat)
            with tracing.span("train.backward", device=True):
                grads = torch.autograd.grad(loss, leaves)
            with tracing.span("train.grad_sum", device=True):
                loss = loss.detach().float()
                if accum == 1:
                    loss_sum, acc = loss, list(grads)
                elif acc is None:
                    loss_sum, acc = loss, [g.float() for g in grads]
                else:
                    loss_sum = loss_sum + loss
                    for a, g in zip(acc, grads):
                        a.add_(g)
                del grads
        with tracing.span("train.grad_sum", device=True):
            if accum > 1:
                loss_sum = loss_sum / accum
                for a in acc:
                    a.div_(accum)
            acc = [g.redistribute(p.device_mesh, p.placements) if isinstance(g, DTensor) else g
                   for g, p in zip(acc, leaves)]
        by_path = dict(zip((path for path, _ in tree_items(state.params)), acc))
        grads = tree_map_with_path(lambda path, _: by_path[path], state.params)
        for p in leaves:
            p.requires_grad_(False)

        residual = state.residual
        if plan.compress_grads and residual is not None:
            grads, residual = compress_lib.tree_compress_with_feedback(grads, residual)
        params, opt, opt_metrics = adamw_update(
            grads, state.opt, state.params, lr=lr, weight_decay=weight_decay,
            warmup_steps=warmup_steps, total_steps=total_steps)
        return TrainState(params, opt, residual), {"loss": loss_sum, **opt_metrics}

    return step


def place_state(state: TrainState, shardings: TrainState) -> TrainState:
    """``state`` placed by ``shardings`` (``sharding.rules.place`` at every leaf);
    the step counter stays where it is."""
    from repro_torch.sharding.rules import place_tree

    residual = state.residual
    if residual is not None:
        residual = compress_lib.CompressedState(place_tree(residual.residual,
                                                           shardings.residual.residual))
    return TrainState(place_tree(state.params, shardings.params),
                      AdamWState(state.opt.step, place_tree(state.opt.mu, shardings.opt.mu),
                                 place_tree(state.opt.nu, shardings.opt.nu)), residual)


def jit_train_step(api: ModelApi, plan: ParallelPlan, mesh, abstract_batch, **kw):
    """(fn, abstract_state, state_shardings, batch_shardings): ``fn(state, batch) ->
    (state, metrics)`` on ``mesh`` (``sharding.rules.step_mesh``'s), with
    ``build_train_step``'s keywords ``kw``. ``abstract_batch`` is the batch's tree
    (any tensors of its shapes)."""
    from repro_torch.sharding.rules import (place, place_tree, replicated, step_mesh,
                                            tree_batch_shardings)

    mesh, plan = step_mesh(mesh, plan, [x.shape[0] for _, x in tree_items(abstract_batch)])
    step = build_train_step(api, plan, **kw)
    abstract, state_sh = make_train_state_specs(api, plan, mesh)
    batch_sh = tree_batch_shardings(abstract_batch, plan, mesh)
    rep = replicated(mesh)

    def fn(state: TrainState, batch):
        state = place_state(state, state_sh)
        batch = place_tree(batch, batch_sh)
        with implicit_replication():
            state, metrics = step(state, batch)
        return place_state(state, state_sh), {k: place(v, rep) for k, v in metrics.items()}

    return fn, abstract, state_sh, batch_sh
