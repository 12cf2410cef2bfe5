"""Dispatcher: composition orchestration within a worker node (SS5, SS6.1).

Tracks pending invocations, function readiness (all input sets fed),
instance fan-out per edge keywords, data movement between contexts,
context deallocation once all consumers have taken a function's outputs,
idempotent re-execution on failure, and hedged backups for stragglers.

Cross-node scheduling hook: when a ``placer`` is attached (see
``cluster.CrossNodePlacer``), every vertex that becomes ready (all input
sets fed — the per-vertex ready-set export) is offered back to the
cluster layer, which may place it on a different node. A remotely placed
vertex runs its instances on that node's engines (and touches that
node's code cache); if any of its inputs were produced on another node,
the placer charges transfer tasks and the vertex waits behind a
*remote-input barrier* (``VertexRun.barrier``) until every transfer
lands, resumed via ``launch_placed``. With no placer attached (the
default), no cross-node code runs and behavior is byte-identical to the
single-node dispatcher.

Contract / determinism invariants:

  * every ``MemoryContext`` created for an invocation — instance
    contexts and cross-node staging contexts alike — is freed exactly
    once, on success, failure, timeout, hedging, and node failure
    (pinned by tests/test_dispatcher_properties.py and
    tests/test_crossnode.py);
  * instance submission order is a pure function of DAG structure and
    arrival order (engine FIFO-per-kind does the rest), so dataflow and
    virtual timelines are byte-stable run to run;
  * cache-miss sampling uses a deterministic golden-ratio Weyl sequence,
    not wall-clock RNG.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.coldstart import CodeCache, ColdStartProfile
from repro_torch.core.dag import (
    COMM, COMPUTE, SUBGRAPH, Composition, Edge, RetryPolicy, Vertex,
)
from repro_torch.core.engines import BATCH, EngineSet, Task, release_task_weights
from repro_torch.core.http import IDEMPOTENT_METHODS, HttpRequest
from repro_torch.core.items import Item, ItemSet, SetDict, group_by_key
from repro_torch.core.registry import FunctionRegistry
from repro_torch.core.sim import EventLoop

# structured failure classes (InvocationRun.failure_kind): what failed,
# independent of the human-readable reason string. The cluster restart
# path keys on FAIL_NODE — never on reason substrings — so a user vertex
# named (or failing with a reason containing) "node_failure" cannot
# trigger bogus restarts.
FAIL_ERROR = "error"            # generic task failure (e.g. sanitization)
FAIL_TIMEOUT = "timeout"
FAIL_NODE = "node_failure"
FAIL_CANCELLED = "cancelled"


@dataclass(slots=True)
class InstanceState:
    idx: int
    inputs: SetDict
    done: bool = False
    outputs: SetDict = field(default_factory=dict)
    # highest attempt number submitted for this instance: hedges carry
    # it (no fresh retry budget), and a failing task older than it is a
    # hedge sibling whose retry is already out (deduped, see
    # _on_task_failed)
    attempts: int = 0


@dataclass(frozen=True)
class VertexTemplate:
    """Invocation-invariant orchestration structure of one vertex,
    precomputed once per composition (``composition_template``) instead of
    being re-derived from edge scans on every invocation — serving-scale
    traces invoke the same composition thousands of times, and the
    per-invoke edge scans dominated the dispatcher's hot path."""

    vertex: Vertex
    in_sets: tuple                    # v.inputs (delivered-dict shape)
    pending_feeds: tuple              # ((set_name, feed_count), ...)
    consumers: int                    # distinct downstream consumer vertices
    fan_edge: Optional[Edge]          # the at-most-one each/key in-edge
    consumed_srcs: tuple              # unique upstream vertex names, in
                                      # first-occurrence in_edges order
    out_feeds: tuple                  # (dst_vertex, dst_set, src_set) per
                                      # out-edge, in edge order
    out_bindings: tuple               # (output_name, src_set) bound here


def composition_template(comp: Composition) -> Dict[str, VertexTemplate]:
    """Per-vertex orchestration templates for ``comp``, cached on the
    composition object and invalidated when its structure grows (vertex /
    edge / binding counts change)."""
    key = (
        len(comp.vertices), len(comp.edges),
        len(comp.input_bindings), len(comp.output_bindings),
    )
    cached = comp.__dict__.get("_dispatch_tmpl")
    if cached is not None and cached[0] == key:
        return cached[1]
    tmpl: Dict[str, VertexTemplate] = {}
    for name, v in comp.vertices.items():
        in_edges = comp.in_edges(name)
        pending = []
        for s in v.inputs:
            feeds = sum(1 for e in in_edges if e.dst.set_name == s)
            feeds += sum(
                1 for p in comp.input_bindings.values()
                if p.vertex == name and p.set_name == s
            )
            pending.append((s, feeds))
        fan = None
        consumed: List[str] = []
        for e in in_edges:
            if fan is None and e.mode in ("each", "key"):
                fan = e
            if e.src.vertex not in consumed:
                consumed.append(e.src.vertex)
        out_edges = comp.out_edges(name)
        tmpl[name] = VertexTemplate(
            vertex=v,
            in_sets=tuple(v.inputs),
            pending_feeds=tuple(pending),
            consumers=len({e.dst.vertex for e in out_edges}),
            fan_edge=fan,
            consumed_srcs=tuple(consumed),
            out_feeds=tuple(
                (e.dst.vertex, e.dst.set_name, e.src.set_name)
                for e in out_edges
            ),
            out_bindings=tuple(
                (out_name, p.set_name)
                for out_name, p in comp.output_bindings.items()
                if p.vertex == name
            ),
        )
    comp.__dict__["_dispatch_tmpl"] = (key, tmpl)
    return tmpl


@dataclass(slots=True)
class VertexRun:
    vertex: Vertex
    tmpl: Optional[VertexTemplate] = None
    delivered: Dict[str, ItemSet] = field(default_factory=dict)
    pending_feeds: Dict[str, int] = field(default_factory=dict)
    launched: bool = False
    instances: List[InstanceState] = field(default_factory=list)
    n_done: int = 0
    outputs: SetDict = field(default_factory=dict)
    contexts: List[Any] = field(default_factory=list)
    consumers_left: int = 0
    done_t: float = 0.0
    # ---- cross-node placement (None/0/empty on the local path)
    exec_node: Any = None           # WorkerNode the placer chose (None=home)
    exec_engines: Any = None        # that node's EngineSet (None=home)
    exec_code_cache: Any = None     # that node's CodeCache
    exec_weights: Any = None        # that node's WeightStore
    barrier: int = 0                # outstanding inbound transfer tasks
    placed_release: Optional[Callable[[], None]] = None  # vload decrement
    # inbound transfer staging contexts: freed at THIS vertex's own
    # completion (its instances copied the bytes), not the consumer-driven
    # lifecycle instance contexts follow — a zero-instance vertex must
    # still release its staged bytes
    staged: List[Any] = field(default_factory=list)
    # nested InvocationRun while a SUBGRAPH vertex is in flight (so
    # cancellation can cascade into it)
    sub_inv: Any = None


@dataclass(slots=True)
class InvocationRun:
    inv_id: int
    comp: Composition
    on_done: Optional[Callable[["InvocationRun"], None]]
    t_start: float
    inputs: SetDict = field(default_factory=dict)
    vertex_runs: Dict[str, VertexRun] = field(default_factory=dict)
    remaining: int = 0
    outputs: SetDict = field(default_factory=dict)
    done: bool = False
    failed: Optional[str] = None
    # structured failure class (FAIL_* above) set alongside ``failed``;
    # the cluster restart path and cancellation bookkeeping key on this,
    # never on reason substrings
    failure_kind: Optional[str] = None
    t_end: float = 0.0
    # live engine tasks by id: registered at submit, dropped at the
    # completion/failure callback. Cancellation marks them cancelled and
    # balances their weight touches; failure flushes the still-queued
    # ones so a dead invocation cannot leak work into live engine slots
    live_tasks: Dict[int, Task] = field(default_factory=dict)
    # back-pointer to the admitting dispatcher (set in Dispatcher.invoke)
    # so handles can route cancel() without knowing the node
    dispatcher: Any = field(default=None, repr=False, compare=False)

    @property
    def latency(self) -> float:
        return self.t_end - self.t_start

    @property
    def cancelled(self) -> bool:
        return self.failure_kind == FAIL_CANCELLED


class Dispatcher:
    def __init__(
        self,
        loop: EventLoop,
        engines: EngineSet,
        registry: FunctionRegistry,
        *,
        profiles: Optional[Dict[str, ColdStartProfile]] = None,
        comm_profile_cpu_only: bool = False,
        max_retries: int = 2,
        default_retry: Optional[RetryPolicy] = None,  # node-level policy
        hedge_after_s: float = 0.0,   # 0 = hedging off
        hedge_min_instances: int = 4,
        cache_miss_rate: float = 0.0,  # fraction of requests loading from disk
        code_cache: Optional["CodeCache"] = None,  # per-node residency model
        placer: Optional[Any] = None,  # cluster.CrossNodePlacer (attached)
        weights: Optional[Any] = None,  # workloads.WeightStore (per node)
    ):
        self.loop = loop
        self.engines = engines
        self.registry = registry
        # keep the caller's dict object (even while empty): platforms
        # share one profiles dict across nodes and populate it at deploy
        self.profiles = {} if profiles is None else profiles
        self.max_retries = max_retries
        self.default_retry = default_retry
        self.hedge_after_s = hedge_after_s
        self.hedge_min_instances = hedge_min_instances
        self.cache_miss_rate = cache_miss_rate
        self.code_cache = code_cache
        self.placer = placer
        self.weights = weights
        self._ids = itertools.count()
        self.completed_count = 0
        self.failed_count = 0
        self.active: Dict[int, InvocationRun] = {}
        self.rng_seq = itertools.count()

    # ----------------------------------------------------- control signals
    @property
    def outstanding(self) -> int:
        """Invocations admitted but not yet completed/failed."""
        return len(self.active)

    def queue_delay_s(self) -> float:
        """Worst queue-wait EWMA across engine types: how long work sits
        before a slot serves it. The elastic control plane's scale-up
        signal (queue growth precedes latency SLO violations). An engine
        kind's EWMA counts only while that kind has queued work - a stale
        EWMA after a drained burst must not keep triggering scale-ups."""
        q = self.engines.queue_lengths()
        return max(
            (self.engines.queue_delay_ewma[k] for k, n in q.items() if n > 0),
            default=0.0,
        )

    # ------------------------------------------------------------------
    def invoke(
        self,
        comp: Composition,
        inputs: SetDict,
        on_done: Optional[Callable[[InvocationRun], None]] = None,
    ) -> InvocationRun:
        tmpl = composition_template(comp)
        inv = InvocationRun(
            inv_id=next(self._ids), comp=comp, on_done=on_done,
            t_start=self.loop.now, inputs=inputs,
            remaining=len(comp.vertices),
            dispatcher=self,
        )
        self.active[inv.inv_id] = inv
        vruns = inv.vertex_runs
        for name, vt in tmpl.items():
            vruns[name] = VertexRun(
                vertex=vt.vertex,
                tmpl=vt,
                delivered={s: [] for s in vt.in_sets},
                pending_feeds=dict(vt.pending_feeds),
                consumers_left=vt.consumers,
            )
        # deliver composition-level inputs
        for in_name, port in comp.input_bindings.items():
            self._feed(inv, port.vertex, port.set_name, inputs.get(in_name, []))
        return inv

    # ------------------------------------------------------------------
    def _feed(self, inv: InvocationRun, vertex: str, set_name: str, items: ItemSet):
        vr = inv.vertex_runs[vertex]
        vr.delivered[set_name].extend(items)
        pf = vr.pending_feeds
        pf[set_name] -= 1
        if vr.launched:
            return
        for c in pf.values():
            if c > 0:
                return
        vr.launched = True
        self._launch(inv, vr)

    # ------------------------------------------------------------------
    def _fan_edge(self, inv: InvocationRun, vr: VertexRun) -> Optional[Edge]:
        if vr.tmpl is not None:
            return vr.tmpl.fan_edge
        for e in inv.comp.in_edges(vr.vertex.name):
            if e.mode in ("each", "key"):
                return e
        return None

    def _make_instances(self, inv: InvocationRun, vr: VertexRun) -> List[InstanceState]:
        fan = self._fan_edge(inv, vr)
        base = dict(vr.delivered)
        if fan is None:
            return [InstanceState(0, base)]
        fan_set = fan.dst.set_name
        fan_items = vr.delivered[fan_set]
        insts = []
        if fan.mode == "each":
            for i, it in enumerate(fan_items):
                d = dict(base)
                d[fan_set] = [it]
                insts.append(InstanceState(i, d))
        else:  # key
            for i, (k, items) in enumerate(sorted(group_by_key(fan_items).items())):
                d = dict(base)
                d[fan_set] = items
                insts.append(InstanceState(i, d))
        if not insts:  # empty fan-out: vertex produces empty outputs
            insts = []
        return insts

    def _launch(self, inv: InvocationRun, vr: VertexRun):
        # upstream contexts can be released once this consumer has copied
        # its inputs (captured in the instance input dicts below); the
        # template's consumed_srcs is already deduped to one entry per
        # (src, this) vertex pair, so each upstream is decremented once
        vruns = inv.vertex_runs
        for src in vr.tmpl.consumed_srcs:
            up = vruns[src]
            up.consumers_left -= 1
            if up.consumers_left == 0 and up.n_done == len(up.instances) and up.instances:
                self._free_vertex_contexts(up)

        if self.placer is not None and self.placer.place(self, inv, vr):
            # inbound cross-node transfers in flight (remote placement, or
            # a home-pinned comm/subgraph vertex pulling remote producers'
            # outputs back): the placer resumes us via launch_placed
            return
        self._launch_ready(inv, vr)

    def launch_placed(self, inv: InvocationRun, vr: VertexRun):
        """Remote-input barrier release: every inbound transfer task for a
        placed vertex has completed; it may now run."""
        if inv.failed:
            return
        self._launch_ready(inv, vr)

    def _launch_ready(self, inv: InvocationRun, vr: VertexRun):
        if vr.vertex.kind == SUBGRAPH:
            self._launch_subgraph(inv, vr)
        else:
            self._launch_instances(inv, vr)

    def _launch_instances(self, inv: InvocationRun, vr: VertexRun):
        tmpl = vr.tmpl
        if tmpl is not None and tmpl.fan_edge is None:
            # no fan-out edge: exactly one instance over the delivered
            # sets (what _make_instances returns, without the dispatch)
            vr.instances = [InstanceState(0, dict(vr.delivered))]
        else:
            vr.instances = self._make_instances(inv, vr)
        if not vr.instances:
            self._vertex_done(inv, vr)
            return
        placer = self.placer
        if (
            placer is not None
            and getattr(placer, "spread_instances", False)
            and len(vr.instances) > 1
            and vr.vertex.kind == COMPUTE
            and vr.exec_engines is None
        ):
            # fan-out spreading: the placer scatters instances across the
            # cluster (vr stays home-anchored; outputs gather back before
            # downstream vertices consume them)
            placer.spread(self, inv, vr)
        else:
            for inst in vr.instances:
                self._submit_instance(inv, vr, inst)
        if (
            self.hedge_after_s > 0
            and len(vr.instances) >= self.hedge_min_instances
        ):
            self.loop.after(self.hedge_after_s, lambda: self._hedge(inv, vr))

    def _launch_subgraph(self, inv: InvocationRun, vr: VertexRun):
        sub = vr.vertex.subgraph

        def sub_done(sub_inv: InvocationRun):
            vr.sub_inv = None
            if sub_inv.failed:
                # propagate the structured kind: a node death inside the
                # nested graph must still reach the cluster restart path
                self._fail(inv, f"{vr.vertex.name}: {sub_inv.failed}",
                           kind=sub_inv.failure_kind or FAIL_ERROR)
                return
            vr.outputs = sub_inv.outputs
            vr.instances = [InstanceState(0, {})]
            vr.n_done = 1
            self._vertex_done(inv, vr, merged=True)

        vr.sub_inv = self.invoke(sub, vr.delivered, on_done=sub_done)

    # ------------------------------------------------------------------
    def _submit_instance(
        self, inv: InvocationRun, vr: VertexRun, inst: InstanceState,
        attempts: int = 0, remote: Optional[Any] = None,
    ) -> Task:
        """Build and submit one instance's engine task. ``remote`` (a
        WorkerNode, set only by the placer's instance spreading) overrides
        the executing engines/caches/weights per *instance* — retries of
        a spread instance fall back to the home node."""
        v = vr.vertex
        kind = COMM if v.kind == COMM else COMPUTE
        if remote is not None:
            engines = remote.engines
        else:
            engines = vr.exec_engines or self.engines
        # batchable compute vertices go to the executing node's batching
        # engine when it models one; platforms without batch slots run
        # them as ordinary compute tasks (identical dataflow, unshared
        # step durations — the batching-off baseline). The probe is
        # "models a batching engine", not "has live replicas": an elastic
        # node (per-fn batch_models) scaled to zero must queue batch work
        # where the replica autoscaler can see it, not leak it onto CPU
        # slots
        if kind == COMPUTE and engines._models_batching():
            cf = self.registry.functions.get(v.function)
            if cf is None:
                cf = self.registry.get(v.function)  # contractual KeyError
            if cf.batchable:
                kind = BATCH
        # remotely placed vertices run on the target node's engines and
        # warm the target node's code cache (locality is per node)
        code_cache = (
            self.code_cache if vr.exec_engines is None else vr.exec_code_cache
        )
        if remote is not None:
            code_cache = remote.code_cache
        cached = True
        if kind != COMM and code_cache is not None:
            cached = code_cache.touch(v.function)
        elif self.cache_miss_rate > 0:
            # deterministic low-discrepancy (golden-ratio Weyl) sequence:
            # misses interleave uniformly across the run instead of the
            # old counter scheme's front-loaded block of misses
            cached = (next(self.rng_seq) * 0.6180339887498949) % 1.0 >= self.cache_miss_rate
        meta = {"inv": inv, "vr": vr, "inst": inst}
        # model-weight residency (workloads.WeightStore) is per executing
        # node, like the code cache; a miss makes the task pay its
        # profile's deterministic cold_setup_s term. The store — not the
        # code-cache bit — is the authority for functions it handles: a
        # code miss must never bill a weight load that is resident
        cold_setup = not cached
        weights = self.weights if vr.exec_engines is None else vr.exec_weights
        if remote is not None:
            weights = remote.weight_store
            meta["engines"] = engines   # failure flush needs the real queue
        if kind != COMM and weights is not None and weights.handles(v.function):
            cold_setup = not weights.touch(v.function)
            meta["wstore"] = weights
        task = Task(
            kind=kind,
            fn_name=v.function if kind != COMM else "http",
            inputs=inst.inputs,
            context_bytes=v.context_bytes,
            profile=self.profiles.get(v.function),
            cached=cached,
            cold_setup=cold_setup,
            batch_units=v.batch_units if kind == BATCH else 1,
            timeout_s=v.timeout_s,
            attempts=attempts,
            meta=meta,
            on_complete=self._on_task_complete,
            on_failed=self._on_task_failed,
        )
        if attempts > inst.attempts:
            inst.attempts = attempts
        inv.live_tasks[id(task)] = task
        engines.submit(task)
        return task

    def _hedge(self, inv: InvocationRun, vr: VertexRun):
        if inv.failed or vr.n_done == len(vr.instances):
            return
        for inst in vr.instances:
            if not inst.done:
                # the backup rides the instance's REAL attempt count: a
                # hedged straggler must not hand its failures a fresh
                # retry budget
                self._submit_instance(inv, vr, inst, attempts=inst.attempts)

    # ------------------------------------------------------------------
    def _on_task_complete(self, task: Task, outputs: SetDict, ctx):
        # weight refcounts are released in the finally, AFTER successor
        # vertices have been fed and submitted (their touch lands first):
        # a back-to-back decode chain keeps its model's inflight count
        # above zero, so weights survive even at keepalive 0
        try:
            inv: InvocationRun = task.meta["inv"]
            vr: VertexRun = task.meta["vr"]
            inst: InstanceState = task.meta["inst"]
            inv.live_tasks.pop(id(task), None)
            if inv.failed or inst.done:  # hedge loser or dead invocation
                ctx.free()
                return
            inst.done = True
            inst.outputs = outputs
            vr.contexts.append(ctx)
            vr.n_done += 1
            if vr.n_done == len(vr.instances):
                self._vertex_done(inv, vr)
        finally:
            release_task_weights(task)

    def _policy(self, vr: VertexRun) -> RetryPolicy:
        """Effective retry policy: vertex override, else the node-level
        default, else the legacy ``max_retries`` knob (zero backoff,
        timeouts fatal — the historical behavior)."""
        if vr.vertex.retry is not None:
            return vr.vertex.retry
        if self.default_retry is not None:
            return self.default_retry
        return RetryPolicy(max_retries=self.max_retries)

    @staticmethod
    def _comm_idempotent(inst: InstanceState) -> bool:
        """Whether every request payload of a COMM instance is safe to
        re-send. Empty/whitespace payloads carry no method at all — they
        cannot mutate anything, so they count as idempotent (the old
        ``split()[0]`` probe crashed on them instead)."""
        for it in inst.inputs.get("requests", []):
            if not it.data:
                continue
            if isinstance(it.data, HttpRequest):
                method = it.data.method
            else:
                words = str(it.data).split()
                if not words:
                    continue
                method = words[0]
            if method not in IDEMPOTENT_METHODS:
                return False
        return True

    def _on_task_failed(self, task: Task, reason: str):
        # release in the finally: a zero-backoff retry's re-touch must
        # land before this attempt's refcount drops (same rule as
        # _on_task_complete). A backed-off retry re-touches at resubmit
        # time instead — during the wait the task is not in flight, so
        # the weights may legitimately reap and the retry pays the cold
        # term again.
        try:
            inv: InvocationRun = task.meta["inv"]
            vr: VertexRun = task.meta["vr"]
            inst: InstanceState = task.meta["inst"]
            inv.live_tasks.pop(id(task), None)
            if inv.failed or inst.done:
                return
            if task.attempts < inst.attempts:
                # hedge sibling of an attempt that already failed and
                # re-armed: its retry is out — don't double-retry
                return
            kind = FAIL_TIMEOUT if reason == "timeout" else FAIL_ERROR
            policy = self._policy(vr)
            idempotent = (
                self._comm_idempotent(inst) if vr.vertex.kind == COMM
                else True
            )
            if (
                idempotent
                and task.attempts < policy.max_retries
                and policy.retryable(kind)
            ):
                next_attempts = task.attempts + 1
                delay = policy.backoff_s(task.attempts)
                if delay <= 0.0:
                    # synchronous resubmit: the historical event ordering
                    # (an after(0) round-trip through the heap would run
                    # behind events already queued at this instant)
                    self._submit_instance(inv, vr, inst,
                                          attempts=next_attempts)
                else:
                    inst.attempts = next_attempts  # dedupe while waiting

                    def resubmit():
                        if inv.failed or inst.done:
                            return
                        self._submit_instance(inv, vr, inst,
                                              attempts=next_attempts)

                    self.loop.after(delay, resubmit)
            elif reason == "timeout":
                self._fail(inv, f"{vr.vertex.name}: timeout (preempted)",
                           kind=FAIL_TIMEOUT)
            else:
                self._fail(
                    inv,
                    f"{vr.vertex.name}: {reason}"
                    + ("" if idempotent else " (not idempotent; not retried)"),
                    kind=kind,
                )
        finally:
            release_task_weights(task)

    # ------------------------------------------------------------------
    def _vertex_done(self, inv: InvocationRun, vr: VertexRun, merged: bool = False):
        if not merged:
            insts = vr.instances
            if len(insts) == 1:
                # single-instance fast path (every non-fanned vertex):
                # instance output lists are per-invocation already —
                # fresh from the function body or shallow-copied by the
                # payload memo — so they can be taken without re-copying
                io = insts[0].outputs
                vr.outputs = {s: io.get(s) or [] for s in vr.vertex.outputs}
            else:
                vr.outputs = {}
                for s in vr.vertex.outputs:
                    vr.outputs[s] = []
                    for inst in insts:
                        vr.outputs[s].extend(inst.outputs.get(s, []))
        vr.done_t = self.loop.now
        if vr.placed_release is not None:
            vr.placed_release()
            vr.placed_release = None
        if vr.staged:
            for c in vr.staged:
                c.free()
            vr.staged = []

        tmpl = vr.tmpl
        for dst_vertex, dst_set, src_set in tmpl.out_feeds:
            self._feed(inv, dst_vertex, dst_set, vr.outputs[src_set])
        for out_name, src_set in tmpl.out_bindings:
            inv.outputs[out_name] = vr.outputs[src_set]
        if vr.consumers_left <= 0:
            self._free_vertex_contexts(vr)

        inv.remaining -= 1
        if inv.remaining == 0 and not inv.failed:
            inv.done = True
            inv.t_end = self.loop.now
            self.completed_count += 1
            self.active.pop(inv.inv_id, None)
            if inv.on_done:
                inv.on_done(inv)

    def _free_vertex_contexts(self, vr: VertexRun):
        for c in vr.contexts:
            c.free()
        vr.contexts = []

    def _fail(self, inv: InvocationRun, reason: str,
              kind: str = FAIL_ERROR):
        if inv.failed:
            return
        inv.failed = reason
        inv.failure_kind = kind
        self.failed_count += 1
        inv.t_end = self.loop.now
        self.active.pop(inv.inv_id, None)
        # flush still-QUEUED sibling tasks: a dead invocation must not
        # leak its pending work into live engine slots (in-flight tasks
        # keep their already-charged busy time; their callbacks observe
        # inv.failed and release through the normal path)
        for task in list(inv.live_tasks.values()):
            engines = (task.meta.get("engines")          # spread instance
                       or task.meta["vr"].exec_engines or self.engines)
            if id(task) not in engines.inflight_tasks:
                task.cancelled = True
                release_task_weights(task)
                inv.live_tasks.pop(id(task), None)
        # release whatever is still held
        for vr in inv.vertex_runs.values():
            if vr.placed_release is not None:
                vr.placed_release()
                vr.placed_release = None
            for c in vr.staged:
                c.free()
            vr.staged = []
            self._free_vertex_contexts(vr)
        if inv.on_done:
            inv.on_done(inv)

    # ------------------------------------------------------------------
    def cancel(self, inv: InvocationRun) -> bool:
        """Cancel a live invocation. Flushes its queued vertices, marks
        every live engine task ``cancelled`` (queued tasks are skipped at
        dispatch; in-flight tasks free their context without firing a
        callback), balances each task's weight touch exactly once,
        cascades into nested subgraph invocations, and fails the
        invocation with kind ``FAIL_CANCELLED`` — which the cluster never
        restarts. Returns False if the invocation already finished."""
        if inv.done or inv.failed:
            return False
        for vr in inv.vertex_runs.values():
            sub = vr.sub_inv
            if sub is not None and not sub.done and not sub.failed:
                self.cancel(sub)
            for inst in vr.instances:
                inst.done = True   # suppress straggling completions
        # in-flight cancelled tasks never reach a callback, so their
        # weight touch is balanced here (idempotent via the meta pop:
        # callbacks that DO fire release nothing twice)
        for task in list(inv.live_tasks.values()):
            task.cancelled = True
            release_task_weights(task)
        inv.live_tasks.clear()
        self._fail(inv, "cancelled", kind=FAIL_CANCELLED)
        return True
