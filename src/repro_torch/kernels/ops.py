"""Kernel entry points the model calls: one per kernel.

A tensor on the CPU goes to the kernel's plain PyTorch version. A CUDA
tensor goes to the hand-written kernel, which launches or raises; there is
no fallback from one to the other. Each kernel module counts its launches.
A ``meta`` tensor (the dry-run, ``launch.dryrun``) goes to the kernel's
wrapper too, which returns empty outputs of the kernel's shapes and dtypes and
launches nothing.

Each call is a kernel scope for the counters of ``launch.hlo_counter`` that
are on (``observers``): they are told the kernel's ``cost`` (its operations
and bytes, as its bound counts them) and see none of the ATen ops inside the
call, so a step counts the same on ``meta`` tensors, on the CPU (the plain
version) and on the card.

Under autograd (grad mode on and an input that requires grad) ``rmsnorm``
and ``flash_attention`` go to their ``torch.autograd.Function`` on every
device: the forward is the kernel (its plain version on the CPU, empty
outputs on ``meta``), the backward the gradient formula in torch ops, which
the counters count op by op. ``decode_attention``, ``moe_gmm`` and ``ssd``
have no backward yet: on a CUDA tensor they raise ``NotImplementedError``
there, rather than return an output that no gradient passes through; on the
CPU and on ``meta`` they run their plain version inside the kernel scope, so
the forward counts by ``cost`` and the backward by the plain version's
gradient ops on both. Serving runs under ``torch.inference_mode()``.

A ``DTensor`` (the sharded steps of ``serving.engine`` and
``training.train_step``) runs the same call on its local shard: the kernel
on the card, the plain version on the CPU, one launch per call. Each input
dim is either one the kernel treats independently (a "role": rows of
``rmsnorm``; batch and heads of the two attentions, with whole GQA groups
on a rank; experts of ``moe_gmm``; batch, heads and head_dim of ``ssd``) or
one it reduces over. A mesh dimension that shards a role keeps it, and the
inputs without that role are replicated over it (their gradient there is a
``Partial`` sum of each rank's share); every other sharding
(and a ``Partial`` sum) is redistributed to ``Replicate()`` first. The
output is sharded as its roles are. ``to_local`` and ``from_local`` are
differentiable, so gradients pass through the autograd functions on the
shards. A plain tensor beside a DTensor (an all-valid mask) is taken as
replicated.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import moe_gmm as _gmm
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels import ssd as _ssd
from repro_torch.sharding.constraints import grad_placed

_KERNELS = {"rmsnorm": _rms, "flash_attention": _flash, "decode_attention": _decode,
            "moe_gmm": _gmm, "ssd": _ssd}


# the counters of launch.hlo_counter that are on: each has kernel_begin(name, cost) and
# kernel_end()
observers: List = []


@contextlib.contextmanager
def _kernel(name: str, cost: Callable):
    """One kernel call: ``cost()`` (the module's ``cost`` on this call's inputs) goes
    to every observer, which counts no ATen op until the call returns."""
    if not observers:
        yield
        return
    c = cost()
    for o in observers:
        o.kernel_begin(name, c)
    try:
        yield
    finally:
        for o in observers:
            o.kernel_end()


def _meta_autograd(*tensors) -> bool:
    return tensors[0].device.type == "meta" and _wants_grad(*tensors)


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _no_backward(name: str, *tensors) -> None:
    if _wants_grad(*tensors):
        raise NotImplementedError(
            f"{name}: the CUDA kernel has no backward yet; it runs under "
            f"torch.no_grad()/inference_mode() or on CPU tensors (its plain version)")


Roles = Dict[str, int]   # role name -> tensor dim


def shard_plan(tensors: Sequence[DTensor], roles: Sequence[Roles]) -> List[Optional[str]]:
    """Per mesh dimension, the role it shards in the local call, or None (replicated).

    A mesh dimension keeps the first role (in the order the inputs name them)
    that some input is sharded on there, if every input with that role divides
    its dim by the mesh dimensions that keep the role."""
    mesh = tensors[0].device_mesh
    order = list(dict.fromkeys(name for r in roles for name in r))
    plan: List[Optional[str]] = []
    for i in range(mesh.ndim):
        cands = {name for t, r in zip(tensors, roles) for name, d in r.items()
                 if t.placements[i] == Shard(d)}
        plan.append(next((name for name in order if name in cands), None))
    for name in dict.fromkeys(p for p in plan if p is not None):
        ways = math.prod(mesh.size(i) for i, p in enumerate(plan) if p == name)
        if any(name in r and t.shape[r[name]] % ways for t, r in zip(tensors, roles)):
            plan = [None if p == name else p for p in plan]
    return plan


def placements_for(plan: Sequence[Optional[str]], roles: Roles):
    return tuple(Shard(roles[p]) if p in roles else Replicate() for p in plan)


def on_shards(fn: Callable, tensors: Sequence, roles: Sequence[Roles],
              out_roles: Sequence[Roles]):
    """``fn`` on the local shards of ``tensors`` (DTensors, plain tensors taken as
    replicated, or None), redistributed by ``shard_plan``; its output(s) as
    DTensors sharded by ``out_roles``."""
    mesh = next(t for t in tensors if isinstance(t, DTensor)).device_mesh
    rep = (Replicate(),) * mesh.ndim
    live = [i for i, t in enumerate(tensors) if t is not None]
    dts = [tensors[i] if isinstance(tensors[i], DTensor)
           else DTensor.from_local(tensors[i], mesh, rep, run_check=False) for i in live]
    plan = shard_plan(dts, [roles[i] for i in live])
    local: List = [None] * len(tensors)
    for i, t in zip(live, dts):
        placed = placements_for(plan, roles[i])
        # an input whole on a mesh dimension that shards a role it lacks (a norm's
        # scale beside batch-sharded rows) gets each rank's share of the gradient
        grad = tuple(Partial() if p is not None and p not in roles[i] else q
                     for p, q in zip(plan, placed))
        local[i] = grad_placed(t).redistribute(mesh, placed).to_local(grad_placements=grad)
    out = fn(*local)
    outs = out if isinstance(out, tuple) else (out,)
    wrapped = tuple(DTensor.from_local(o, mesh, placements_for(plan, r), run_check=False)
                    for o, r in zip(outs, out_roles))
    return wrapped if isinstance(out, tuple) else wrapped[0]


def _rows(x) -> Roles:
    return {f"row{d}": d for d in range(x.dim() - 1)}


_ATTN = {"b": 0, "h": 2}   # [B, S, H, dh] and the caches [B, S, K, dh]


def rmsnorm(x, scale, *, eps: float = 1e-5):
    if isinstance(x, DTensor):
        return on_shards(lambda xl, sl: rmsnorm(xl, sl, eps=eps), (x, scale),
                         (_rows(x), {}), (_rows(x),))
    with _kernel("rmsnorm", lambda: _rms.cost(x, scale)):
        if _wants_grad(x, scale):
            return _rms.RMSNormFunction.apply(x, scale, eps)
        if x.device.type == "cpu":
            return _rms.plain(x, scale, eps)
        return _rms.rmsnorm(x, scale, eps)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: Optional[float] = None):
    if isinstance(q, DTensor):
        return on_shards(lambda *t: flash_attention(*t, causal=causal, window=window, scale=scale),
                         (q, k, v), (_ATTN,) * 3, (_ATTN,))
    with _kernel("flash_attention", lambda: _flash.cost(q, k, v, causal=causal, window=window)):
        if _wants_grad(q, k, v):
            return _flash.FlashAttentionFunction.apply(q, k, v, causal, window, scale)
        if q.device.type == "cpu":
            return _flash.plain(q, k, v, causal=causal, window=window, scale=scale)
        return _flash.flash_attention(q, k, v, causal=causal, window=window, scale=scale)


def decode_attention(q, k_cache, v_cache, slot_pos, cur_pos, *, window: int = 0,
                     scale: Optional[float] = None):
    if isinstance(q, DTensor):
        row = {"b": 0, "h": 1}
        return on_shards(lambda *t: decode_attention(*t, window=window, scale=scale),
                         (q, k_cache, v_cache, slot_pos, cur_pos),
                         (row, _ATTN, _ATTN, {"b": 0}, {"b": 0}), (row,))
    with _kernel("decode_attention",
                 lambda: _decode.cost(q, k_cache, v_cache, slot_pos, cur_pos)):
        if q.device.type == "cpu" or _meta_autograd(q, k_cache, v_cache):
            return _decode.plain(q, k_cache, v_cache, slot_pos, cur_pos, window=window,
                                 scale=scale)
        _no_backward("decode_attention", q, k_cache, v_cache)
        return _decode.decode_attention(q, k_cache, v_cache, slot_pos, cur_pos, window=window,
                                        scale=scale)


def moe_gmm(xe, we, live=None):
    """``live`` int32 [E, G]: leading rows of each group's block that may be non-zero."""
    if isinstance(xe, DTensor):
        e = {"e": 0}
        return on_shards(moe_gmm, (xe, we, live), (e, e, e), (e,))
    with _kernel("moe_gmm", lambda: _gmm.cost(xe, we)):
        if xe.device.type == "cpu" or _meta_autograd(xe, we):
            return _gmm.plain(xe, we, live)
        _no_backward("moe_gmm", xe, we)
        return _gmm.moe_gmm(xe, we, live)


def ssd(x, a, b, c, *, chunk: int):
    """(y, final state); the chunk length is ``min(chunk, S)``, as in the Pallas kernel."""
    if isinstance(x, DTensor):
        return on_shards(lambda *t: ssd(*t, chunk=chunk), (x, a, b, c),
                         ({"b": 0, "h": 2, "p": 3}, {"b": 0, "h": 2}, {"b": 0}, {"b": 0}),
                         ({"b": 0, "h": 2, "p": 3}, {"b": 0, "h": 1, "p": 2}))
    with _kernel("ssd", lambda: _ssd.cost(x, a, b, c, chunk=chunk)):
        if x.device.type == "cpu" or _meta_autograd(x, a, b, c):
            return _ssd.plain(x, a, b, c, min(chunk, x.shape[1]))
        _no_backward("ssd", x, a, b, c)
        return _ssd.ssd(x, a, b, c, chunk=chunk)


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return {name: mod.launches for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.launches = 0
