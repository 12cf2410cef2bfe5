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
``make_train_state_specs`` gives the state's abstract tree and its
placements on a ``DeviceMesh`` (``sharding.rules``), as the reference's gives
its shardings. ``launch.train`` runs the step on a world of one, which
needs no placements. The reference's ``jit_train_step``, the step sharded
over a mesh larger than one device, waits for ROADMAP A8's sharded step,
which consumes them.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.config.parallel import ParallelPlan
from repro_torch.models.common import tree_items, tree_map, tree_map_with_path
from repro_torch.models.model import ModelApi
from repro_torch.training import compress as compress_lib
from repro_torch.training.optimizer import AdamWState, adamw_init, adamw_update


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
    meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")
    params = api.abstract_params()
    f32 = lambda: tree_map(lambda p: meta(p.shape, torch.float32), params)
    residual = compress_lib.CompressedState(residual=f32()) if plan.compress_grads else None
    return TrainState(params, AdamWState(meta((), torch.int32), f32(), f32()), residual)


def make_train_state_specs(api: ModelApi, plan: ParallelPlan, mesh) -> Tuple[TrainState, TrainState]:
    """(abstract_state, state_placements): the state on ``meta`` tensors, and a
    ``TrainState`` of ``sharding.rules.MeshSharding`` leaves on ``mesh``. The
    moments and the residual inherit the parameters' placements; ``step`` is
    replicated."""
    from repro_torch.sharding.rules import param_shardings, replicated

    abstract = abstract_train_state(api, plan)
    pshard = param_shardings(api.param_template, mesh, plan, kind="train")
    placements = TrainState(
        params=pshard,
        opt=AdamWState(step=replicated(mesh), mu=pshard, nu=pshard),
        residual=compress_lib.CompressedState(residual=pshard) if plan.compress_grads else None,
    )
    return abstract, placements


def _split_microbatches(batch: Dict[str, torch.Tensor], accum: int):
    for key, x in batch.items():
        if x.shape[0] % accum:
            raise ValueError(f"batch {x.shape[0]} ({key}) not divisible by grad_accum {accum}")
    n = next(iter(batch.values())).shape[0] // accum
    return [{k: x[i * n:(i + 1) * n] for k, x in batch.items()} for i in range(accum)]


def build_train_step(api: ModelApi, plan: ParallelPlan, *, lr: float = 3e-4,
                     weight_decay: float = 0.1, warmup_steps: int = 100,
                     total_steps: int = 10000) -> Callable:
    """``step(state, batch) -> (state, metrics)``; ``batch`` holds tensors on the
    parameters' device (``data.to_device``)."""

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        leaves = [p for _, p in tree_items(state.params)]
        for p in leaves:
            p.requires_grad_(True)
        accum = max(1, plan.grad_accum)
        loss_sum, acc = None, None
        for mb in _split_microbatches(batch, accum):
            loss = api.train_loss(state.params, mb, remat=plan.remat)
            grads = torch.autograd.grad(loss, leaves)
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
        if accum > 1:
            loss_sum = loss_sum / accum
            for a in acc:
                a.div_(accum)
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
