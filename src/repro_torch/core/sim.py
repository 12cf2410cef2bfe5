"""Deterministic discrete-event loop with a virtual clock.

All platform benchmarks run in virtual time: service durations come either
from real measured executions (the cold-start code paths and jitted
compute functions actually run; see repro_torch.core.coldstart) or from seeded
latency models (remote HTTP services). Virtual time makes thousand-RPS
load sweeps reproducible and fast on a single-core container while
preserving true queueing behaviour.

Fast-path notes (the full-scale Azure-trace runs):

  * ``EventLoop.at_stream`` injects a pre-sorted arrival stream through a
    single cursor entry on the heap instead of one heap entry per future
    event, so a million-event trace costs O(1) heap residency.
  * ``Timeline`` keeps O(1) streaming aggregates (time-weighted integral,
    peak, last value) and coalesces equal consecutive values, so
    ``average()``/``peak()`` no longer re-walk unbounded point lists.
"""
from __future__ import annotations

import heapq
import itertools
from bisect import bisect_left
from typing import Callable, Iterable, List, Optional, Tuple


class EventLoop:
    def __init__(self):
        self._now = 0.0
        self._heap: List[Tuple[float, int, bool, Callable[[], None]]] = []
        self._seq = itertools.count()
        self._live = 0  # non-daemon events outstanding

    @property
    def now(self) -> float:
        return self._now

    def at(self, time: float, fn: Callable[[], None], daemon: bool = False) -> None:
        """Schedule ``fn``. Daemon events (periodic controller/reaper ticks)
        do not keep the loop alive: ``run()`` stops once only daemons remain."""
        if time < self._now - 1e-12:
            raise ValueError(f"event in the past: {time} < {self._now}")
        heapq.heappush(self._heap, (time, next(self._seq), daemon, fn))
        if not daemon:
            self._live += 1

    def after(self, delay: float, fn: Callable[[], None], daemon: bool = False) -> None:
        self.at(self._now + max(0.0, delay), fn, daemon=daemon)

    def at_stream(
        self,
        arrivals: Iterable[Tuple[float, object]],
        fn: Callable[[object], None],
        daemon: bool = False,
    ) -> None:
        """Bulk trace injection: replay a time-sorted ``(t, payload)``
        stream by keeping a single cursor event on the heap. Each firing
        calls ``fn(payload)`` and schedules the next arrival, so replaying
        a full production trace does not pre-load one heap entry (plus one
        closure) per future event."""
        it = iter(arrivals)
        pending = next(it, None)
        if pending is None:
            return

        def fire():
            nonlocal pending
            t, payload = pending
            fn(payload)
            pending = next(it, None)
            if pending is not None:
                if pending[0] < t - 1e-12:
                    raise ValueError(
                        f"arrival stream not sorted: {pending[0]} after {t}"
                    )
                self.at(max(pending[0], self._now), fire, daemon=daemon)

        self.at(pending[0], fire, daemon=daemon)

    def step(self) -> bool:
        if not self._heap:
            return False
        t, _, daemon, fn = heapq.heappop(self._heap)
        self._now = t
        if not daemon:
            self._live -= 1
        fn()
        return True

    def run(self, until: Optional[float] = None, max_events: int = 50_000_000):
        n = 0
        while self._heap and n < max_events:
            if until is None and self._live == 0:
                return
            if until is not None and self._heap[0][0] > until:
                self._now = until
                return
            self.step()
            n += 1
        if n >= max_events:
            raise RuntimeError("event budget exhausted (livelock?)")

    def empty(self) -> bool:
        return self._live == 0


class _LoopShard:
    """One shard (one node) of a ``ShardedEventLoop``: the full
    ``EventLoop`` scheduling surface (``now``/``at``/``after``/
    ``at_stream``) over a private heap, sharing the owner's global
    sequence counter and non-daemon liveness count.

    In exact mode (owner ``lookahead_s == 0``) ``now`` reads the owner's
    global clock, so cross-shard scheduling — a dispatcher submitting a
    ``TRANSFER`` onto another node's comm engine — computes exactly the
    times it would on one merged heap. With lookahead each shard keeps a
    local clock that may run ahead of the global one by at most
    ``lookahead_s``."""

    __slots__ = ("_owner", "name", "_heap", "_local_now")

    def __init__(self, owner: "ShardedEventLoop", name: str):
        self._owner = owner
        self.name = name
        self._heap: List[Tuple[float, int, bool, Callable[[], None]]] = []
        self._local_now = owner._now

    @property
    def now(self) -> float:
        o = self._owner
        return o._now if o.lookahead_s <= 0.0 else self._local_now

    def at(self, time: float, fn: Callable[[], None], daemon: bool = False) -> None:
        if time < self.now - 1e-12:
            raise ValueError(f"event in the past: {time} < {self.now}")
        o = self._owner
        heapq.heappush(self._heap, (time, next(o._seq), daemon, fn))
        if not daemon:
            o._live += 1

    def after(self, delay: float, fn: Callable[[], None], daemon: bool = False) -> None:
        self.at(self.now + max(0.0, delay), fn, daemon=daemon)

    def at_stream(
        self,
        arrivals: Iterable[Tuple[float, object]],
        fn: Callable[[object], None],
        daemon: bool = False,
    ) -> None:
        """Cursor-based trace injection onto this shard; semantics match
        ``EventLoop.at_stream``."""
        it = iter(arrivals)
        pending = next(it, None)
        if pending is None:
            return

        def fire():
            nonlocal pending
            t, payload = pending
            fn(payload)
            pending = next(it, None)
            if pending is not None:
                if pending[0] < t - 1e-12:
                    raise ValueError(
                        f"arrival stream not sorted: {pending[0]} after {t}"
                    )
                self.at(max(pending[0], self.now), fire, daemon=daemon)

        self.at(pending[0], fire, daemon=daemon)

    def _step(self) -> None:
        t, _, daemon, fn = heapq.heappop(self._heap)
        self._local_now = t
        o = self._owner
        if o.lookahead_s <= 0.0:
            o._now = t          # exact mode: one shared clock
        if not daemon:
            o._live -= 1
        fn()


class ShardedEventLoop:
    """Node-sharded event loop: per-shard heaps over one global virtual
    clock and one global sequence counter.

    ``shard(name)`` returns the named shard view (created on first use).
    The loop object itself exposes the plain ``EventLoop`` API — ``at``/
    ``after``/``at_stream`` land on a built-in *control* shard (platform
    arrival streams, cluster routing, control-plane ticks), so it is a
    drop-in replacement wherever an ``EventLoop`` is expected.

    Two execution modes:

    * ``lookahead_s == 0.0`` (default, **exact**): ``run()`` repeatedly
      executes the globally minimal ``(time, seq)`` event across every
      shard heap. The sequence counter is global, so the pop order is
      exactly what a single merged heap would produce — execution is
      byte-identical to ``EventLoop``, event for event, for any workload
      (pinned by tests/test_shard_equivalence.py). The value is
      structural: each node's events live in a small private heap that a
      future parallel driver can own.
    * ``lookahead_s > 0.0`` (**conservative windows**): the shard owning
      the globally minimal event at ``t_min`` drains its own heap up to
      ``t_min + lookahead_s`` before the next global selection. This
      batches per-node work but changes cross-shard interleaving, so it
      is only sound when shards interact exclusively through explicitly
      latency-delayed edges — cross-node ``TRANSFER`` tasks whose wire
      latency is at least ``lookahead_s`` (the classic conservative-
      synchronization lower bound: no event a remote shard schedules can
      land inside another shard's current window). Byte identity is NOT
      part of this mode's contract; the exact default is.
    """

    def __init__(self, lookahead_s: float = 0.0):
        if lookahead_s < 0.0:
            raise ValueError("lookahead_s must be >= 0")
        self._now = 0.0
        self._seq = itertools.count()
        self._live = 0
        self.lookahead_s = lookahead_s
        self._control = _LoopShard(self, "_control")
        self._shards: List[_LoopShard] = [self._control]
        self._by_name: dict = {}

    # ------------------------------------------------------------ shards
    def shard(self, name: str) -> _LoopShard:
        """The shard for ``name`` (one per node), created on first use."""
        s = self._by_name.get(name)
        if s is None:
            s = self._by_name[name] = _LoopShard(self, name)
            self._shards.append(s)
        return s

    @property
    def shards(self) -> List[_LoopShard]:
        return list(self._shards)

    # ----------------------------------------- EventLoop-compatible API
    @property
    def now(self) -> float:
        return self._now

    def at(self, time: float, fn: Callable[[], None], daemon: bool = False) -> None:
        self._control.at(time, fn, daemon=daemon)

    def after(self, delay: float, fn: Callable[[], None], daemon: bool = False) -> None:
        self._control.after(delay, fn, daemon=daemon)

    def at_stream(self, arrivals, fn, daemon: bool = False) -> None:
        self._control.at_stream(arrivals, fn, daemon=daemon)

    def empty(self) -> bool:
        return self._live == 0

    # --------------------------------------------------------- execution
    def _min_shard(self) -> Optional[_LoopShard]:
        best = None
        bh = None
        for s in self._shards:
            h = s._heap
            if h and (bh is None or h[0][0] < bh[0][0]
                      or (h[0][0] == bh[0][0] and h[0][1] < bh[0][1])):
                best, bh = s, h
        return best

    def step(self) -> bool:
        """One globally minimal event (exact order), regardless of mode."""
        best = self._min_shard()
        if best is None:
            return False
        t = best._heap[0][0]
        if t > self._now:
            self._now = t
        best._step()
        return True

    def run(self, until: Optional[float] = None, max_events: int = 50_000_000):
        n = 0
        la = self.lookahead_s
        while n < max_events:
            best = self._min_shard()
            if best is None:
                break                     # every heap drained
            if until is None and self._live == 0:
                return                    # only daemons remain
            t_min = best._heap[0][0]
            if until is not None and t_min > until:
                self._advance_to(until)
                return
            if la <= 0.0:
                best._step()
                n += 1
            else:
                horizon = t_min + la
                if until is not None and horizon > until:
                    horizon = until
                if t_min > self._now:
                    self._now = t_min     # committed global time
                h = best._heap
                while h and h[0][0] <= horizon and n < max_events:
                    best._step()
                    n += 1
                    if until is None and self._live == 0:
                        return
        if n >= max_events:
            raise RuntimeError("event budget exhausted (livelock?)")

    def _advance_to(self, t: float) -> None:
        self._now = t
        for s in self._shards:
            if s._local_now < t:
                s._local_now = t


class Timeline:
    """Step-function series with O(1) streaming aggregates.

    ``record(t, value)`` maintains a running time-weighted integral, peak,
    and last value, so ``average()``/``peak()`` are O(1) instead of
    re-walking an unbounded point list. The point list itself is still
    kept (``keep_points=True``, the default) with equal consecutive values
    coalesced — consumers that need the full step function (``merged_peak``,
    journaling tests) read ``points``; at full trace scale a tracker can
    opt out with ``keep_points=False``.

    ``average(t_end)`` with a historical ``t_end`` (before the last
    recorded point — e.g. a measurement window queried after draining
    stragglers) stays fast too: ``record`` maintains a per-point cumulative
    integral (``_cum``) with the same left-to-right arithmetic as the O(n)
    reference walk, so historical queries are an O(log n) bisect that
    returns the bit-identical total. ``_scan_integral`` is retained as the
    brute-force reference (pinned by tests/test_timeline_average.py).
    """

    __slots__ = ("points", "keep_points", "_t0", "_last_t", "_last_v",
                 "_integral", "_peak", "_cum")

    def __init__(self, keep_points: bool = True):
        self.points: List[Tuple[float, float]] = []
        self.keep_points = keep_points
        self._t0: Optional[float] = None
        self._last_t = 0.0
        self._last_v = 0.0
        self._integral = 0.0
        self._peak = 0.0
        # _cum[i] = integral of the step function from points[0][0] to
        # points[i][0], accumulated over the *coalesced* segments exactly
        # like _scan_integral does (term order matters for float identity)
        self._cum: List[float] = []

    def record(self, t: float, value: float):
        if self._t0 is None:
            self._t0 = t
        else:
            self._integral += self._last_v * (t - self._last_t)
        if self.keep_points and (not self.points or self.points[-1][1] != value):
            if self.points:
                pt, pv = self.points[-1]
                self._cum.append(self._cum[-1] + pv * (t - pt))
            else:
                self._cum.append(0.0)
            self.points.append((t, value))
        self._last_t = t
        self._last_v = value
        if value > self._peak:
            self._peak = value

    # ------------------------------------------------------ aggregates
    @property
    def t0(self) -> Optional[float]:
        return self._t0

    @property
    def last_t(self) -> float:
        return self._last_t

    @property
    def last_value(self) -> float:
        return self._last_v

    def average(self, t_end: Optional[float] = None) -> float:
        """Time-weighted average over [first point, t_end]. Points recorded
        after ``t_end`` are excluded (a run may drain stragglers past the
        measurement window; they must not inflate the window's average)."""
        if self._t0 is None:
            return 0.0
        t_end = t_end if t_end is not None else self._last_t
        if t_end >= self._last_t:
            total = self._integral + self._last_v * (t_end - self._last_t)
        else:
            total = self._integral_until(t_end)
        span = t_end - self._t0
        return total / span if span > 0 else self._last_v

    def _integral_until(self, t_end: float) -> float:
        """Integral over [points[0][0], t_end] for a historical window
        (t_end < last_t): O(log n) bisect into the streaming per-point
        cumulative integral. Bit-identical to ``_scan_integral`` because
        ``_cum`` is accumulated with the same term order at record time."""
        if not self.keep_points:
            raise ValueError(
                "historical average() needs keep_points=True "
                "(or query the window before recording past it)"
            )
        # first retained point with t >= t_end; a bare (t_end,) tuple
        # compares below any (t_end, v) point, so ties resolve leftward
        i = bisect_left(self.points, (t_end,))
        if i == 0:
            return 0.0
        pt, pv = self.points[i - 1]
        return self._cum[i - 1] + pv * (t_end - pt)

    def _scan_integral(self, t_end: float) -> float:
        """O(n) reference walk for historical windows (t_end < last_t)."""
        if not self.keep_points:
            raise ValueError(
                "historical average() needs keep_points=True "
                "(or query the window before recording past it)"
            )
        total = 0.0
        pts = self.points
        for (t0, v), (t1, _) in zip(pts, pts[1:]):
            if t0 >= t_end:
                break
            total += v * (min(t1, t_end) - t0)
        else:
            if pts and t_end > pts[-1][0]:
                total += pts[-1][1] * (t_end - pts[-1][0])
        return total

    def peak(self) -> float:
        return self._peak


def merged_peak(timelines: List["Timeline"]) -> float:
    """Exact peak of the sum of several committed-value step functions
    (per-node memory timelines -> cluster-wide peak). Requires the member
    timelines to retain points; an aggregate parent ``MemoryTracker``
    (see repro_torch.core.context) gives the same answer in O(1)."""
    deltas: List[Tuple[float, float]] = []
    for tl in timelines:
        prev = 0.0
        for t, v in tl.points:
            deltas.append((t, v - prev))
            prev = v
    deltas.sort(key=lambda d: d[0])
    cur = peak = 0.0
    for _, d in deltas:
        cur += d
        peak = max(peak, cur)
    return peak
