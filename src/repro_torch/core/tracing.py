"""Latency / memory instrumentation shared by benchmarks and tests, and the port's
spans on the profiler's clock.

Spans (the end of this file). ``span("<layer>.<stage>")`` opens the host range
``repro_torch.<layer>.<stage>`` in the torch profiler, at function scope: on the
trace's own clock, nested in the enclosing span of its thread, with no event on the
device's timeline. ``span(name, device=True)`` also times the stage on the device: a
CUDA event pair on the current stream (none while a CUDA graph is being captured),
added to ``device_seconds()[name]`` once the end has completed, with no
synchronisation (pairs wait, a bounded number, until they are read); the stream's time
between the two, idle time inside included. With no card it counts host seconds.
``stages()`` runs adjacent stages as such spans, one event between two stages, and
under autograd times each stage's backward as ``<name>.backward``. While tracing is on,
each pass of Python's collector is the span ``repro_torch.python.gc``.

Tracing is on exactly while a ``torch.profiler.profile`` records: there is no other
switch. Off, a span costs one flag check. To trace a run, record it with any torch
profiler (``export_chrome_trace`` lays the spans beside the kernels) and read
``device_seconds()`` for each device-timed stage. Tracing changes no result.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler


@dataclass
class LatencyStats:
    samples: List[float] = field(default_factory=list)

    def add(self, seconds: float):
        self.samples.append(seconds)

    def percentile(self, p: float) -> float:
        if not self.samples:
            return 0.0
        return float(np.percentile(np.asarray(self.samples), p))

    @property
    def p50(self) -> float:
        return self.percentile(50)

    @property
    def p95(self) -> float:
        return self.percentile(95)

    @property
    def p99(self) -> float:
        return self.percentile(99)

    @property
    def mean(self) -> float:
        return float(np.mean(self.samples)) if self.samples else 0.0

    @property
    def relative_variance(self) -> float:
        """Variance / mean^2 in percent (the paper's SS7.6 metric)."""
        if len(self.samples) < 2 or self.mean == 0:
            return 0.0
        return float(np.var(self.samples) / self.mean**2) * 100.0

    def summary(self) -> Dict[str, float]:
        return {
            "n": len(self.samples),
            "mean_ms": self.mean * 1e3,
            "p50_ms": self.p50 * 1e3,
            "p95_ms": self.p95 * 1e3,
            "p99_ms": self.p99 * 1e3,
            "rel_var_pct": self.relative_variance,
        }


# ===========================================================================
# Control-plane instrumentation (Dirigent-style routing + autoscaling)
# ===========================================================================
@dataclass
class NodeCounters:
    """Per-node routing/cache/memory counters the control plane exports."""

    name: str
    routed: int = 0            # invocations this node received
    affinity_routed: int = 0   # ...of which via code-cache affinity
    cache_hits: int = 0
    cache_misses: int = 0
    committed_avg_bytes: float = 0.0

    @property
    def cache_hit_rate(self) -> float:
        total = self.cache_hits + self.cache_misses
        return self.cache_hits / total if total else 0.0

    def row(self) -> Dict[str, float]:
        return {
            "node": self.name,
            "routed": self.routed,
            "affinity_routed": self.affinity_routed,
            "cache_hit_rate": self.cache_hit_rate,
            "committed_avg_mb": self.committed_avg_bytes / 1024**2,
        }


@dataclass
class RoutingStats:
    """Cluster-wide routing-decision and scaling-event counters."""

    affinity_hits: int = 0     # routed to a node with warm code cache
    spillover: int = 0         # load-aware fallback (power-of-two-choices)
    scale_ups: int = 0
    scale_downs: int = 0
    drains: int = 0            # nodes that drained in-flight work first
    per_node: Dict[str, NodeCounters] = field(default_factory=dict)
    fn_routed: Dict[str, int] = field(default_factory=dict)  # popularity

    def node(self, name: str) -> NodeCounters:
        if name not in self.per_node:
            self.per_node[name] = NodeCounters(name)
        return self.per_node[name]

    def record_route(self, node_name: str, affinity: bool, fns=()):
        nc = self.node(node_name)
        nc.routed += 1
        if affinity:
            nc.affinity_routed += 1
            self.affinity_hits += 1
        else:
            self.spillover += 1
        for fn in fns:
            self.fn_routed[fn] = self.fn_routed.get(fn, 0) + 1

    def hot_functions(self, k: int) -> List[str]:
        """Top-``k`` most-routed functions — the P2P distributor's "what
        is hot" feed. Deterministic: count descending, name ascending on
        ties."""
        ranked = sorted(self.fn_routed.items(), key=lambda kv: (-kv[1], kv[0]))
        return [fn for fn, _ in ranked[:k]]

    def summary(self) -> Dict[str, float]:
        total = self.affinity_hits + self.spillover
        return {
            "routed": total,
            "affinity_hit_rate": self.affinity_hits / total if total else 0.0,
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "drains": self.drains,
        }


# ===========================================================================
# Cross-node transfer instrumentation (per-link comm-engine charging)
# ===========================================================================
@dataclass
class LinkCounters:
    """One directed inter-node link's transfer accounting."""

    src: str
    dst: str
    transfers: int = 0
    bytes_total: int = 0
    cpu_s: float = 0.0      # sender comm-slot CPU charged
    wire_s: float = 0.0     # modeled latency + bytes/bandwidth time

    def row(self) -> Dict[str, float]:
        return {
            "src": self.src,
            "dst": self.dst,
            "transfers": self.transfers,
            "bytes_total": self.bytes_total,
            "cpu_ms": self.cpu_s * 1e3,
            "wire_ms": self.wire_s * 1e3,
        }


@dataclass
class TransferStats:
    """Cross-node placement + transfer counters (``CrossNodePlacer``).

    One ``LinkCounters`` per directed (src, dst) node pair; every edge of
    a composition whose producer and consumer vertices executed on
    different nodes is charged exactly one transfer task (the invariant
    tests/test_crossnode.py pins down)."""

    local_placements: int = 0    # vertices kept on the routed home node
    remote_placements: int = 0   # vertices placed on a different node
    links: Dict[Tuple[str, str], LinkCounters] = field(default_factory=dict)

    def link(self, src: str, dst: str) -> LinkCounters:
        key = (src, dst)
        if key not in self.links:
            self.links[key] = LinkCounters(src, dst)
        return self.links[key]

    def record_transfer(self, src: str, dst: str, nbytes: int,
                        cpu_s: float, wire_s: float):
        lc = self.link(src, dst)
        lc.transfers += 1
        lc.bytes_total += nbytes
        lc.cpu_s += cpu_s
        lc.wire_s += wire_s

    @property
    def transfers(self) -> int:
        return sum(lc.transfers for lc in self.links.values())

    @property
    def bytes_total(self) -> int:
        return sum(lc.bytes_total for lc in self.links.values())

    def summary(self) -> Dict[str, float]:
        placed = self.local_placements + self.remote_placements
        return {
            "placements": placed,
            "remote_placement_rate": (
                self.remote_placements / placed if placed else 0.0
            ),
            "transfers": self.transfers,
            "transfer_mb": self.bytes_total / 1024**2,
            "links": len(self.links),
        }




# ===========================================================================
# Spans inside the port, on the profiler's clock
# ===========================================================================
PREFIX = "repro_torch."
_OFF = contextlib.nullcontext()


class _DeviceClock:
    """Device seconds by span name. A pair of CUDA events waits in ``pending`` and is
    resolved once its end has completed (events on one stream complete in order, so
    the oldest is polled first): when ``PENDING`` pairs wait, or when the counts are
    read. Resolved events are recorded again, but for an end that a later pair starts
    at (``shared``), which waits for that pair. With no card a point is a host clock
    read."""

    PENDING = 4096

    def __init__(self) -> None:
        self.seconds: Dict[str, float] = {}
        self.pending: collections.deque = collections.deque()
        self.free: List[torch.cuda.Event] = []
        self.streams: Dict[tuple, torch.cuda.Stream] = {}
        self.cuda: Optional[bool] = None
        self.lock = threading.Lock()

    def mark(self):
        """A point on the current stream: None while a CUDA graph is being captured."""
        if self.cuda is None:
            self.cuda = torch.cuda.is_available()
        if not self.cuda:
            return time.perf_counter()  # det-lint: waive[wall-clock] reason=tracing; a CPU run's stage time is measured, not modeled
        if torch.cuda.is_current_stream_capturing():
            return None
        return self._event()

    def again(self, start):
        """A later point of ``start``'s kind, with no second capture check (None where
        ``start`` is None)."""
        if start is None:
            return None
        if isinstance(start, float):
            return time.perf_counter()  # det-lint: waive[wall-clock] reason=tracing; a CPU run's stage time is measured, not modeled
        return self._event()

    def _event(self) -> torch.cuda.Event:
        # the current stream's object, kept: ``torch.cuda.current_stream()`` builds a
        # new one each call, several µs of a span's cost
        key = torch._C._cuda_getCurrentStream(torch._C._cuda_getDevice())
        stream = self.streams.get(key)
        if stream is None:
            stream = self.streams[key] = torch.cuda.Stream(stream_id=key[0], device_index=key[1],
                                                           device_type=key[2])
        try:
            ev = self.free.pop()
        except IndexError:
            ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    def add(self, name: str, start, end, shared: bool = False) -> None:
        if start is None or end is None:
            return
        with self.lock:
            if isinstance(start, float):
                self.seconds[name] = self.seconds.get(name, 0.0) + (end - start)
            else:
                self.pending.append((name, start, end, shared))
                if len(self.pending) >= self.PENDING:
                    self.resolve(wait=False)

    def resolve(self, wait: bool) -> None:
        while self.pending:
            name, start, end, shared = self.pending[0]
            if wait:
                end.synchronize()
            elif not end.query():
                return
            self.pending.popleft()
            self.seconds[name] = self.seconds.get(name, 0.0) + start.elapsed_time(end) / 1e3
            self.free.append(start)
            if not shared:
                self.free.append(end)


_clock = _DeviceClock()
_gc_open: List[_RecordFunctionFast] = []
_gc_hooked = False


def _on_gc(phase: str, info) -> None:
    if phase == "start":
        if _profiler._is_profiler_enabled:
            rf = _RecordFunctionFast(PREFIX + "python.gc")
            rf.__enter__()
            _gc_open.append(rf)
    elif _gc_open:
        _gc_open.pop().__exit__(None, None, None)


def _hook_gc() -> None:
    global _gc_hooked
    if not _gc_hooked:
        gc.callbacks.append(_on_gc)
        _gc_hooked = True


class _Span:
    __slots__ = ("name", "device", "_rf", "_start")

    def __init__(self, name: str, device: bool):
        self.name, self.device = name, device

    def __enter__(self):
        _hook_gc()
        self._rf = _RecordFunctionFast(self.name)
        self._rf.__enter__()
        if self.device:
            self._start = _clock.mark()
        return self

    def __exit__(self, *exc):
        if self.device:
            _clock.add(self.name, self._start, _clock.again(self._start))
        self._rf.__exit__(*exc)


def span(name: str, device: bool = False):
    """The span ``repro_torch.<name>`` while tracing is on (see the module's
    docstring); a context that does nothing while it is off."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(PREFIX + name, device)


def device_seconds() -> Dict[str, float]:
    """Device seconds of every device-timed span so far, by its full name (pairs
    still pending are waited for here)."""
    with _clock.lock:
        _clock.resolve(wait=True)
        return dict(_clock.seconds)


class _Backward:
    """The backward spans of one run of stages, one open at a time: each mark's
    backward ends the open span and opens the next at one point of the stream."""
    __slots__ = ("name", "start", "rf")

    def __init__(self):
        self.name = self.start = self.rf = None

    def turn(self, to: Optional[str]) -> None:
        if self.name is not None:
            at = _clock.again(self.start)
            _clock.add(self.name, self.start, at, shared=to is not None)
            self.rf.__exit__(None, None, None)
        else:
            at = _clock.mark()
        self.name, self.start, self.rf = to, at, None
        if to is not None:
            self.rf = _RecordFunctionFast(to)
            self.rf.__enter__()


class _Mark(torch.autograd.Function):
    """Identity on a stage's inputs; its backward, the end of the stage's backward,
    turns to ``to`` (the stage before's backward, or none)."""

    @staticmethod
    def forward(ctx, back, to, *xs):
        ctx.back, ctx.to = back, to
        ctx.set_materialize_grads(False)   # an input the stage only reads passes None on
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.back.turn(ctx.to)
        return (None, None) + grads


class _Open(_Mark):
    """Identity on the last stage's outputs; its backward opens that stage's backward."""

    @staticmethod
    def forward(ctx, back, to, *ys):
        # read back before the span opens: a checkpointed block is recomputed on that
        # read, so its recompute falls outside the backward spans and inside the
        # forward spans it runs again
        ctx.save_for_backward(ys[0].new_empty(0))
        return _Mark.forward(ctx, back, to, *ys)

    @staticmethod
    def backward(ctx, *grads):
        ctx.saved_tensors
        return _Mark.backward(ctx, *grads)


def _needs_grad(v) -> bool:
    return isinstance(v, torch.Tensor) and v.requires_grad


def _marked(fn, back, to, values):
    """``values`` with ``fn.apply(back, to, *those that need grad)`` in their place."""
    values = list(values)
    idx = [i for i, v in enumerate(values) if _needs_grad(v)]
    if idx:
        for i, v in zip(idx, fn.apply(back, to, *(values[i] for i in idx))):
            values[i] = v
    return values


class _Stages:
    __slots__ = ("at", "prev", "back")

    def __init__(self):
        self.at = _clock.mark()   # where the next stage starts: the last one's end
        self.prev = None          # the name of the last stage's backward span
        self.back = None if not torch.is_grad_enabled() else _Backward()

    def __call__(self, name: str, fn: Callable, *args, last: bool = False):
        name = PREFIX + name
        rf = _RecordFunctionFast(name)
        rf.__enter__()
        try:
            # a checkpointed block's recompute runs inside the backward pass and its graph
            # is dropped: only the mark that saves a tensor runs again there, as the
            # checkpoint needs
            if self.back is not None and torch._C._current_graph_task_id() == -1:
                args = _marked(_Mark, self.back, self.prev, args)
            out = fn(*args)
            end = _clock.again(self.at)
            _clock.add(name, self.at, end, shared=not last)
            self.at, self.prev = end, name + ".backward"
            if last and self.back is not None:
                outs = _marked(_Open, self.back, self.prev, out if isinstance(out, tuple) else (out,))
                out = tuple(outs) if isinstance(out, tuple) else outs[0]
            return out
        finally:
            rf.__exit__(None, None, None)


def _run(name: str, fn: Callable, *args, last: bool = False):
    return fn(*args)


def stages():
    """A run of device-timed stages while tracing is on: ``run = stages()``, then
    ``run(name, fn, *args)`` for each stage and ``run(name, fn, *args, last=True)`` for
    the last gives ``fn(*args)`` as the span ``name``. A stage starts where the one
    before ended, on one CUDA event. Under autograd an identity mark on each stage's
    inputs that need grad ends the stage's backward, ``<name>.backward``, and opens the
    stage before's; one on the last stage's outputs opens its backward. Off, ``run``
    only calls ``fn``."""
    if not _profiler._is_profiler_enabled:
        return _run
    _hook_gc()
    return _Stages()
