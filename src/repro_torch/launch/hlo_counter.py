"""Per-device FLOP, byte and collective accounting of one step.

Counterpart of ``repro.launch.hlo_counter`` (the name is kept so that a
reader finds it). The reference parses a compiled HLO module; the port has
none, and counts the ATen ops a step dispatches instead: ``CostCounter`` is a
``TorchDispatchMode`` that runs the step once (on ``meta`` tensors in the
dry-run, or live) and counts, per device:

  * **FLOPs:** each ATen op that ``torch.utils.flop_counter``'s formula
    registry knows (mm, addmm, bmm, baddbmm, the convolutions), and each
    hand-written kernel's ``cost`` (``kernels.ops`` tells the counter, and
    the counter sees none of the ATen ops inside the call). Elementwise ops
    count no FLOPs, as in the reference.
  * **Bytes:** for each op, its tensor operands plus its outputs; views,
    allocations and metadata ops are free, as the reference's ``_FREE_OPS``.
    An op that writes part of a tensor (``index_put_``, ``scatter_``,
    ``index_copy_``, ``index_add_``) reads its other operands and writes the
    update's bytes, as the reference charges a dynamic-update-slice. Eager
    PyTorch runs every op as its own kernel, reading its inputs from HBM and
    writing its outputs there, so this unfused sum is the traffic the port
    moves; the reference models XLA's fusions instead.
  * **Collectives:** every ``_c10d_functional`` op (all-gather, all-reduce,
    reduce-scatter, all-to-all) with the size of its group, and operand,
    output and link bytes by the reference's ring model.

There is no while-loop correction: layers run in a Python loop, so every op
is seen once each time it runs. Under ``DTensor`` the counter steps aside for
the DTensor-level op (it returns ``NotImplemented``, as ``CommDebugMode``
does) and counts the local ops and the collectives that DTensor runs for it:
each device's own work, counted once.

The counter also tracks the peak of live bytes that the step allocates
(storages it has not seen before, each watched through a weak reference), the
dry-run's ``temp_bytes``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import ops

aten = torch.ops.aten

# ops that move no HBM bytes: allocations and metadata (views are free by their schema)
_FREE_OPS = frozenset({
    aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty, aten.new_empty_strided,
    aten.detach, aten.lift_fresh, aten.sym_size, aten.sym_stride, aten.sym_numel,
    aten.sym_storage_offset, aten.is_contiguous, aten._local_scalar_dense, aten.set_,
    aten.resize_, aten.is_same_size, aten.is_nonzero,
})
# ops that write part of their first operand: the update's bytes, not the whole tensor
_PARTIAL_WRITES = frozenset({
    aten.index_put_, aten._index_put_impl_, aten.index_copy_, aten.scatter_, aten.scatter_add_,
    aten.scatter_reduce_, aten.index_add_, aten.index_fill_, aten.masked_scatter_,
})
_COLLECTIVES = {"all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
                "reduce_scatter_tensor": "reduce-scatter", "all_to_all_single": "all-to-all"}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd")


def tensor_bytes(t: torch.Tensor) -> float:
    """Bytes of the distinct elements of ``t`` (a broadcast dim of stride 0 counts once)."""
    n = math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0) if t.dim() else 1
    return float(n * t.element_size())


def _tensors(tree, out: Optional[List[torch.Tensor]] = None) -> List[torch.Tensor]:
    """The tensors in nested tuples, lists and dicts (an op's arguments or outputs)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def link_bytes(op: str, operand_bytes: float, output_bytes: float, group: int) -> float:
    """Bytes one device sends over its links, ring schedules (the reference's model)."""
    frac = max(0, group - 1) / max(1, group)
    if op == "all-reduce":
        return 2.0 * output_bytes * frac
    if op == "all-gather":
        return output_bytes * frac
    if op == "reduce-scatter":
        return operand_bytes * frac
    return operand_bytes   # all-to-all


@dataclass(frozen=True)
class CollectiveEvent:
    """One collective a device ran: its base op (the reference's names), operand
    and output bytes, and the size of its group."""
    op: str
    operand_bytes: float
    output_bytes: float
    group_size: int


@dataclass
class CorrectedCosts:
    """Per-device totals for one step.

    collectives: base op -> [count, operand_bytes, output_bytes, link_bytes]
    (link bytes by the ring model; see ``hlo_analysis``). ``kernels``: kernel ->
    [calls, flops, bytes]; ``ops``: ATen op -> [calls, flops, bytes] (kernel
    calls under ``kernel:<name>``); ``events``: every collective in order;
    ``peak_bytes``: the peak of live bytes the step allocated."""

    flops: float
    hbm_bytes: float
    collectives: Dict[str, List[float]] = field(default_factory=dict)
    warnings: List[str] = field(default_factory=list)
    kernels: Dict[str, List[float]] = field(default_factory=dict)
    ops: Dict[str, List[float]] = field(default_factory=dict)
    events: List[CollectiveEvent] = field(default_factory=list)
    peak_bytes: float = 0.0

    @property
    def collective_link_bytes(self) -> float:
        return sum(v[3] for v in self.collectives.values())

    @property
    def collective_operand_bytes(self) -> float:
        return sum(v[1] for v in self.collectives.values())

    def collectives_json(self) -> dict:
        return {
            k: {
                "count": v[0], "operand_bytes": v[1],
                "output_bytes": v[2], "link_bytes": v[3],
            }
            for k, v in self.collectives.items()
        }


def _group_size(func, args, kwargs) -> int:
    names = [a.name for a in func._schema.arguments]
    bound = dict(zip(names, args), **kwargs)
    if "group_size" in bound:
        return int(bound["group_size"])
    from torch.distributed.distributed_c10d import _resolve_process_group

    return int(_resolve_process_group(bound["group_name"]).size())


class CostCounter(TorchDispatchMode):
    """Counts the ops dispatched while it is on (``with CostCounter() as c:``); read
    the totals with ``costs()``. It adds itself to ``kernels.ops.observers`` while
    on, so kernel calls count by their ``cost``."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.depth = 0
        self.kernels: Dict[str, List[float]] = {}
        self.ops: Dict[str, List[float]] = {}
        self.events: List[CollectiveEvent] = []
        self.warnings: List[str] = []
        self._live: Dict[int, Tuple[StorageWeakRef, float]] = {}
        self._live_upper = 0.0
        self.peak_bytes = 0.0

    # -- kernels.ops observer
    def kernel_begin(self, name: str, cost) -> None:
        if self.depth == 0:
            self.flops += cost.flops
            self.bytes += cost.bytes
            for table, key in ((self.kernels, name), (self.ops, f"kernel:{name}")):
                row = table.setdefault(key, [0, 0.0, 0.0])
                row[0] += 1
                row[1] += cost.flops
                row[2] += cost.bytes
        self.depth += 1

    def kernel_end(self) -> None:
        self.depth -= 1

    def __enter__(self):
        ops.observers.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        ops.observers.remove(self)
        return super().__exit__(*exc)

    # -- live bytes
    def _track(self, ins: List[torch.Tensor], outs: List[torch.Tensor]) -> None:
        seen = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._live:
                continue
            seen.add(key)
            nbytes = float(st.nbytes())
            self._live[key] = (StorageWeakRef(st), nbytes)
            self._live_upper += nbytes
            if self._live_upper > self.peak_bytes:
                self._prune()
                self.peak_bytes = max(self.peak_bytes, self._live_upper)

    def _prune(self) -> None:
        for key in [k for k, (ref, _) in self._live.items() if ref.expired()]:
            self._live_upper -= self._live.pop(key)[1]

    def live_keys(self) -> Dict[int, float]:
        """Storages the step allocated that are still alive: key -> bytes."""
        self._prune()
        return {k: b for k, (_, b) in self._live.items()}

    # -- ops
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented   # let DTensor run; count the local ops it dispatches
        if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None:
            # DTensor working out a global output's shape on fake tensors: no device's work
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        self._track(ins, outs)
        if self.depth:
            return out
        packet = func._overloadpacket
        ns = func.namespace
        if ns in _COLLECTIVE_NAMESPACES and packet.__name__ in _COLLECTIVES:
            self._collective(_COLLECTIVES[packet.__name__], func, args, kwargs, ins, outs)
            return out
        if packet in _FREE_OPS or func.is_view or ns in _COLLECTIVE_NAMESPACES:
            return out
        flops = 0.0
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs, out_val=out))
        if packet in _PARTIAL_WRITES:
            rest = ins[1:]
            nbytes = sum(tensor_bytes(t) for t in rest)
            if rest:
                nbytes += rest[-1].numel() * ins[0].element_size()
        else:
            nbytes = sum(tensor_bytes(t) for t in ins) + sum(tensor_bytes(t) for t in outs)
        self.flops += flops
        self.bytes += nbytes
        row = self.ops.setdefault(str(packet), [0, 0.0, 0.0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes
        return out

    def _collective(self, op, func, args, kwargs, ins, outs) -> None:
        self.events.append(CollectiveEvent(op, tensor_bytes(ins[0]),
                                           sum(tensor_bytes(t) for t in outs),
                                           _group_size(func, args, kwargs)))

    def costs(self) -> CorrectedCosts:
        from repro_torch.launch.hlo_analysis import merge_events

        return CorrectedCosts(
            flops=self.flops, hbm_bytes=self.bytes, collectives=merge_events(self.events),
            warnings=list(self.warnings), kernels={k: list(v) for k, v in self.kernels.items()},
            ops={k: list(v) for k, v in self.ops.items()}, events=list(self.events),
            peak_bytes=self.peak_bytes)


def corrected_costs(fn, *args, **kwargs) -> CorrectedCosts:
    """``fn(*args, **kwargs)`` run once under a ``CostCounter``: its per-device totals."""
    with CostCounter() as counter:
        fn(*args, **kwargs)
    return counter.costs()
