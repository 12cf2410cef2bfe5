"""Composition IR: the paper's programming model (SS4.1).

A composition is a DAG G=(V,E). Vertices are (i) user compute functions,
(ii) platform communication functions, or (iii) nested compositions.
Edges carry a metadata descriptor: which output set of V1 feeds which
input set of V2 and a distribution keyword:

    all   -- every instance of V2 receives the whole item set
    each  -- one V2 instance per item
    key   -- one V2 instance per distinct item key

At most one 'each'/'key' edge may target a vertex (it determines the
instance count); 'all' edges broadcast to every instance.

The builder doubles as the composition DSL (SS4.1 "composition language").
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

MODES = ("all", "each", "key")

COMPUTE, COMM, SUBGRAPH = "compute", "comm", "composition"

# ------------------------------------------------------------------ hooks
# Registration hooks: callables invoked with each Composition as a
# FunctionRegistry accepts it — the seam the static-analysis layer
# (repro.analysis.graphlint.registration_lint_hook) plugs into without
# the IR importing the analyzer. The empty-list common case costs one
# truthiness check on the per-request register path.
_REGISTRATION_HOOKS: List[Callable[["Composition"], None]] = []


def add_registration_hook(hook) -> Callable[["Composition"], None]:
    """Install ``hook(comp)`` to run on every composition registration.
    Returns the hook (usable as a decorator)."""
    _REGISTRATION_HOOKS.append(hook)
    return hook


def remove_registration_hook(hook) -> None:
    """Uninstall a previously added hook (no-op if absent)."""
    try:
        _REGISTRATION_HOOKS.remove(hook)
    except ValueError:
        pass


def fire_registration_hooks(comp: "Composition") -> None:
    """Invoke all installed hooks (snapshot, so a hook may uninstall
    itself). Exceptions propagate: a strict lint hook is *supposed* to
    reject the registration."""
    if _REGISTRATION_HOOKS:
        for hook in tuple(_REGISTRATION_HOOKS):
            hook(comp)


@dataclass(frozen=True)
class RetryPolicy:
    """Per-vertex failure handling (SS6.1: pure functions are idempotent,
    so the platform restarts lost work transparently).

    ``max_retries`` resubmissions after the first attempt; each retry
    waits ``base_backoff_s * 2**attempts`` capped at ``max_backoff_s``
    (the astraflow RunOrchestrator schedule). Zero backoff resubmits
    synchronously from the failure callback — the historical behavior,
    and the byte-identity default. Failure classes: generic task errors
    ("error", e.g. comm sanitization) are always retryable within
    budget; "timeout" only when ``retry_timeouts`` is set;
    "node_failure" and "cancelled" are never retried at task level (the
    cluster restart path and the canceller own those)."""

    max_retries: int = 2
    base_backoff_s: float = 0.0
    max_backoff_s: float = 30.0
    retry_timeouts: bool = False

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if self.base_backoff_s < 0 or self.max_backoff_s < 0:
            raise ValueError("backoff durations must be >= 0")
        if self.base_backoff_s > self.max_backoff_s:
            raise ValueError(
                f"base_backoff_s ({self.base_backoff_s}) exceeds "
                f"max_backoff_s ({self.max_backoff_s})"
            )

    def retryable(self, kind: str) -> bool:
        if kind == "timeout":
            return self.retry_timeouts
        return kind == "error"

    def backoff_s(self, attempts_done: int) -> float:
        """Delay before the next resubmission after ``attempts_done``
        attempts have failed: capped exponential, deterministic."""
        if self.base_backoff_s <= 0.0:
            return 0.0
        return min(self.base_backoff_s * (2.0 ** attempts_done),
                   self.max_backoff_s)


@dataclass(frozen=True)
class PortRef:
    vertex: str
    set_name: str


@dataclass
class Vertex:
    name: str
    kind: str                      # compute | comm | composition
    function: str = ""             # registry name (compute) / protocol (comm)
    inputs: Tuple[str, ...] = ()
    outputs: Tuple[str, ...] = ()
    subgraph: Optional["Composition"] = None
    context_bytes: int = 1 << 20   # user-declared memory requirement
    timeout_s: float = 60.0
    retry: Optional[RetryPolicy] = None   # None -> dispatcher default
    # units of a coalesced BATCH step this vertex occupies when its
    # function is batchable (chunked prefill spans several; default 1)
    batch_units: int = 1

    def __getitem__(self, set_name: str) -> PortRef:
        if set_name not in self.inputs and set_name not in self.outputs:
            raise KeyError(f"{self.name}: unknown set {set_name!r}")
        return PortRef(self.name, set_name)


@dataclass(frozen=True)
class Edge:
    src: PortRef
    dst: PortRef
    mode: str = "all"


@dataclass
class Composition:
    """DAG of compute/communication functions (+ nested compositions)."""

    name: str
    vertices: Dict[str, Vertex] = field(default_factory=dict)
    edges: List[Edge] = field(default_factory=list)
    input_bindings: Dict[str, PortRef] = field(default_factory=dict)
    output_bindings: Dict[str, PortRef] = field(default_factory=dict)
    # adjacency cache: per-vertex in/out edge lists in edge-append order.
    # ``edges`` is append-only through the DSL; ``edge()`` maintains the
    # cache incrementally, and direct appends by legacy callers are
    # detected by length and trigger a full rebuild. Direct *non-append*
    # mutation of ``edges`` (element replacement, removal) is outside
    # the contract — undetectable at O(1) unless a later ``edge()`` call
    # notices the length mismatch; no caller does it.
    _in_adj: Dict[str, List[Edge]] = field(
        default_factory=dict, init=False, repr=False, compare=False)
    _out_adj: Dict[str, List[Edge]] = field(
        default_factory=dict, init=False, repr=False, compare=False)
    _adj_edges_n: int = field(default=0, init=False, repr=False, compare=False)

    # ------------------------------------------------------------- DSL
    def _add(self, v: Vertex) -> Vertex:
        if v.name in self.vertices:
            raise ValueError(f"duplicate vertex {v.name!r}")
        self.vertices[v.name] = v
        return v

    def compute(
        self,
        name: str,
        function: str,
        inputs: Tuple[str, ...],
        outputs: Tuple[str, ...],
        context_bytes: int = 1 << 20,
        timeout_s: float = 60.0,
        retry: Optional[RetryPolicy] = None,
    ) -> Vertex:
        return self._add(Vertex(
            name, COMPUTE, function, tuple(inputs), tuple(outputs),
            context_bytes=context_bytes, timeout_s=timeout_s, retry=retry,
        ))

    def http(self, name: str, context_bytes: int = 1 << 20) -> Vertex:
        """The platform HTTP communication function (trusted, SS6.3)."""
        return self._add(Vertex(
            name, COMM, "http", ("requests",), ("responses",),
            context_bytes=context_bytes,
        ))

    def subgraph(self, name: str, comp: "Composition") -> Vertex:
        return self._add(Vertex(
            name, SUBGRAPH, comp.name,
            tuple(comp.input_bindings), tuple(comp.output_bindings),
            subgraph=comp,
        ))

    def edge(self, src: PortRef, dst: PortRef, mode: str = "all") -> None:
        if mode not in MODES:
            raise ValueError(f"edge mode {mode!r} not in {MODES}")
        sv, dv = self.vertices.get(src.vertex), self.vertices.get(dst.vertex)
        if sv is None or dv is None:
            raise ValueError("edge references unknown vertex")
        if src.set_name not in sv.outputs:
            raise ValueError(f"{src.vertex} has no output set {src.set_name!r}")
        if dst.set_name not in dv.inputs:
            raise ValueError(f"{dst.vertex} has no input set {dst.set_name!r}")
        e = Edge(src, dst, mode)
        if self._adj_edges_n == len(self.edges):   # cache fresh: extend it
            self._out_adj.setdefault(e.src.vertex, []).append(e)
            self._in_adj.setdefault(e.dst.vertex, []).append(e)
            self._adj_edges_n += 1
        else:
            # edges was mutated behind the DSL; appending now could make
            # the lengths coincide again, so force the next query to
            # rebuild instead of trusting the stale cache
            self._adj_edges_n = -1
        self.edges.append(e)

    def bind_input(self, name: str, dst: PortRef) -> None:
        self.input_bindings[name] = dst

    def bind_output(self, name: str, src: PortRef) -> None:
        self.output_bindings[name] = src

    # ------------------------------------------------------ validation
    def _refresh_adjacency(self) -> None:
        if self._adj_edges_n == len(self.edges):
            return
        self._in_adj, self._out_adj = {}, {}
        for e in self.edges:
            self._out_adj.setdefault(e.src.vertex, []).append(e)
            self._in_adj.setdefault(e.dst.vertex, []).append(e)
        self._adj_edges_n = len(self.edges)

    def in_edges(self, vertex: str) -> List[Edge]:
        """Edges targeting ``vertex``, in edge-append order. O(1) via the
        adjacency cache; treat the returned list as read-only."""
        self._refresh_adjacency()
        row = self._in_adj.get(vertex)
        return row if row is not None else []

    def out_edges(self, vertex: str) -> List[Edge]:
        """Edges leaving ``vertex``, in edge-append order. O(1) via the
        adjacency cache; treat the returned list as read-only."""
        self._refresh_adjacency()
        row = self._out_adj.get(vertex)
        return row if row is not None else []

    def validate(self) -> None:
        # acyclic
        order = self.topo_order()
        if len(order) != len(self.vertices):
            # every vertex on a cycle is stuck, but so is anything
            # downstream of one — name them as unorderable, not "the"
            # cycle
            stuck = sorted(set(self.vertices) - set(order))
            raise ValueError(
                f"{self.name}: composition graph has a cycle; vertices "
                f"not topologically orderable: {stuck}"
            )
        for v in self.vertices.values():
            fan = [e for e in self.in_edges(v.name) if e.mode in ("each", "key")]
            if len(fan) > 1:
                raise ValueError(
                    f"{v.name}: at most one 'each'/'key' edge may target a vertex"
                )
            # every input set must be fed by an edge or a composition input
            fed = {e.dst.set_name for e in self.in_edges(v.name)}
            fed |= {
                p.set_name for p in self.input_bindings.values()
                if p.vertex == v.name
            }
            missing = set(v.inputs) - fed
            if missing:
                raise ValueError(f"{v.name}: unfed input sets {sorted(missing)}")
            if v.kind == SUBGRAPH:
                v.subgraph.validate()
        for name, p in self.output_bindings.items():
            v = self.vertices.get(p.vertex)
            if v is None or p.set_name not in v.outputs:
                raise ValueError(f"output binding {name!r} invalid")

    def topo_order(self) -> List[str]:
        """Kahn's algorithm with a min-heap ready set: the lexicographic
        tie-break of the old sorted-list/pop(0) implementation at
        O((V+E) log V) instead of re-sorting per pop."""
        indeg = {v: 0 for v in self.vertices}
        for e in self.edges:
            indeg[e.dst.vertex] += 1
        ready = [v for v, d in indeg.items() if d == 0]
        heapq.heapify(ready)
        order: List[str] = []
        while ready:
            v = heapq.heappop(ready)
            order.append(v)
            for e in self.out_edges(v):
                indeg[e.dst.vertex] -= 1
                if indeg[e.dst.vertex] == 0:
                    heapq.heappush(ready, e.dst.vertex)
        return order

    def io_intensity(self) -> float:
        """Fraction of vertices that are communication functions - the
        signal the control plane uses for initial core allocation (SS3)."""
        if not self.vertices:
            return 0.0
        comm = sum(1 for v in self.vertices.values() if v.kind == COMM)
        return comm / len(self.vertices)
