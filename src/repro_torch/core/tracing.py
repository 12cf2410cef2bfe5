"""Latency / memory instrumentation shared by benchmarks and tests."""
from __future__ import annotations

import json
import os
import sys
from dataclasses import dataclass, field
from typing import Dict, IO, List, Optional, Tuple

import numpy as np


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


class StreamingPercentile:
    """O(1)-memory single-quantile estimator (the P² algorithm of Jain &
    Chlamtac): five markers track the running quantile without retaining
    samples, so trace-scale runs can publish live percentiles without the
    O(n) sample lists ``LatencyStats`` keeps.

    Deterministic: the estimate is a pure function of the sample
    sequence. Exact while ``n <= 5``; afterwards a parabolic
    interpolation whose error tests/test_perf_identity.py bounds against
    ``np.percentile`` on the distributions the benchmarks draw."""

    __slots__ = ("p", "n", "_q", "_pos", "_want")

    def __init__(self, p: float):
        if not 0.0 < p < 100.0:
            raise ValueError("percentile must be in (0, 100)")
        self.p = p
        self.n = 0
        self._q: List[float] = []            # marker heights
        self._pos: List[float] = []          # marker positions (1-based)
        self._want: List[float] = []         # desired positions

    def add(self, x: float) -> None:
        q, n = self._q, self.n
        self.n = n + 1
        if n < 5:
            q.append(x)
            q.sort()
            if self.n == 5:
                p = self.p / 100.0
                self._pos = [1.0, 2.0, 3.0, 4.0, 5.0]
                self._want = [1.0, 1 + 2 * p, 1 + 4 * p, 3 + 2 * p, 5.0]
            return
        pos, want = self._pos, self._want
        # which cell the new sample lands in; extremes clamp markers
        if x < q[0]:
            q[0] = x
            k = 0
        elif x >= q[4]:
            q[4] = x
            k = 3
        else:
            k = next(i for i in range(4) if q[i] <= x < q[i + 1])
        for i in range(k + 1, 5):
            pos[i] += 1.0
        p = self.p / 100.0
        inc = (0.0, p / 2, p, (1 + p) / 2, 1.0)
        for i in range(5):
            want[i] += inc[i]
        # nudge interior markers toward their desired positions
        for i in range(1, 4):
            d = want[i] - pos[i]
            if (d >= 1.0 and pos[i + 1] - pos[i] > 1.0) or \
               (d <= -1.0 and pos[i - 1] - pos[i] < -1.0):
                d = 1.0 if d > 0 else -1.0
                qi = self._parabolic(i, d)
                if q[i - 1] < qi < q[i + 1]:
                    q[i] = qi
                else:               # parabolic fit left the bracket
                    q[i] = q[i] + d * (q[i + int(d)] - q[i]) / (
                        pos[i + int(d)] - pos[i]
                    )
                pos[i] += d

    def _parabolic(self, i: int, d: float) -> float:
        q, n = self._q, self._pos
        return q[i] + d / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + d) * (q[i + 1] - q[i]) / (n[i + 1] - n[i])
            + (n[i + 1] - n[i] - d) * (q[i] - q[i - 1]) / (n[i] - n[i - 1])
        )

    @property
    def value(self) -> float:
        if self.n == 0:
            return 0.0
        if self.n <= 5:
            return float(np.percentile(np.asarray(self._q), self.p))
        return self._q[2]


class LiveTelemetry:
    """Incremental metrics publisher in server-sent-events framing.

    Benchmarks run their measurement window in chunks (``platform.run
    (until=t_k)`` checkpoints driven from *outside* the loop — never as
    in-loop daemon events, which would consume sequence numbers and
    break the byte-identity contract) and publish one snapshot per
    checkpoint:

        event: <stream>
        data: {"t": ..., "p50_ttft_ms": ..., "committed_mb": ...}

    The wire format is the standard ``text/event-stream`` one, so the
    emitted file replays through any SSE consumer (or plain ``grep
    '^data:' | jq``). Payload keys are sorted and floats rounded to six
    significant digits, so a telemetry stream from a deterministic run
    is itself deterministic."""

    def __init__(self, sink: IO[str], stream: str = "telemetry"):
        self.sink = sink
        self.stream = stream
        self.events = 0

    @classmethod
    def from_env(cls, var: str, stream: str = "telemetry"
                 ) -> "Optional[LiveTelemetry]":
        """A publisher per the env knob ``var``: unset/empty -> None
        (telemetry off, the default); ``-`` -> stderr; anything else is
        a path to (over)write."""
        dest = os.environ.get(var, "")
        if not dest:
            return None
        if dest == "-":
            return cls(sys.stderr, stream=stream)
        d = os.path.dirname(dest)
        if d:
            os.makedirs(d, exist_ok=True)
        return cls(open(dest, "w"), stream=stream)

    @staticmethod
    def _round(v):
        if isinstance(v, float):
            return float(f"{v:.6g}")
        return v

    def emit(self, payload: Dict[str, object]) -> None:
        body = json.dumps({k: self._round(v) for k, v in payload.items()},
                          sort_keys=True)
        self.sink.write(f"event: {self.stream}\ndata: {body}\n\n")
        self.sink.flush()
        self.events += 1

    def close(self) -> None:
        if self.sink not in (sys.stdout, sys.stderr):
            self.sink.close()


# ===========================================================================
# Simulator wall-clock throughput (the BENCH_simperf.json trajectory)
# ===========================================================================
@dataclass
class ThroughputStats:
    """Events processed per wall-clock second for one simulator segment
    (trace events injected vs. real seconds spent in the event loop)."""

    name: str
    events: int = 0
    wall_s: float = 0.0

    @property
    def events_per_sec(self) -> float:
        return self.events / self.wall_s if self.wall_s > 0 else 0.0

    def row(self) -> Dict[str, float]:
        return {
            "name": self.name,
            "events": self.events,
            "wall_s": self.wall_s,
            "events_per_sec": self.events_per_sec,
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
