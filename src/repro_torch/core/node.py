"""Worker node: engines + dispatcher + PI controller + memory accounting.

One ``WorkerNode`` is the unit Figure 4 draws: HTTP frontend (the
``invoke`` entry point), dispatcher, typed engine queues, engine slots,
and the per-node PI slot controller, all over one (usually shared)
virtual-time event loop.

Contract / determinism invariants:

  * all state a node owns hangs off its ``MemoryTracker`` — committed
    bytes return to zero once every admitted invocation completes or
    fails (freed-exactly-once, see dispatcher);
  * per-node RNG is seeded at construction; identical seed + workload =>
    identical timelines (the byte-identity contract);
  * under cross-node scheduling this node's engines may also serve
    vertices *placed here* by another node's dispatcher, and its comm
    slots may carry outbound ``TRANSFER`` tasks; both are accounted on
    this node's tracker/busy counters, while invocation bookkeeping
    stays with the home node that admitted the request;
  * ``fail()`` kills queued + in-flight work and fails this node's own
    live invocations with "node_failure" (the cluster re-executes them
    on survivors). Invocations homed elsewhere with vertices placed here
    are rescued one layer up: ``ClusterManager.fail_node_at`` notifies
    ``CrossNodePlacer.on_node_failure``, which fails them for the same
    restart path — so in cross-node runs, inject failures through the
    cluster manager, not by calling ``fail()`` directly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

from repro_torch.core.coldstart import CodeCache, ColdStartProfile
from repro_torch.core.context import MemoryTracker
from repro_torch.core.controller import PIController
from repro_torch.core.dag import Composition, RetryPolicy
from repro_torch.core.dispatcher import (
    FAIL_NODE, Dispatcher, InvocationRun, release_task_weights,
)
from repro_torch.core.engines import EngineSet, Task
from repro_torch.core.http import ServiceRegistry
from repro_torch.core.items import SetDict
from repro_torch.core.registry import FunctionRegistry
from repro_torch.core.sim import EventLoop
from repro_torch.core.tracing import LatencyStats


class WorkerNode:
    def __init__(
        self,
        registry: FunctionRegistry,
        services: Optional[ServiceRegistry] = None,
        *,
        loop: Optional[EventLoop] = None,
        num_slots: int = 16,
        comm_slots: int = 1,
        backend: str = "dandelion",
        profiles: Optional[Dict[str, ColdStartProfile]] = None,
        controller_enabled: bool = True,
        controller_interval_s: float = 0.030,
        max_retries: int = 2,
        retry_policy: Optional[RetryPolicy] = None,  # node-wide default
        hedge_after_s: float = 0.0,
        cache_miss_rate: float = 0.0,
        code_cache_entries: int = 0,   # >0 -> model per-node code residency
        base_bytes: int = 0,           # node runtime/OS footprint while up
        batch_slots: int = 0,          # >0 -> model a batching engine
        batch_model=None,              # workloads.BatchStepModel
        batch_models=None,             # per-fn {fn_name: BatchStepModel};
                                       # declares elastic batch capability
        max_batch: int = 32,
        replica_bytes: int = 0,        # RAM arena committed per replica
        weight_store=None,             # workloads.WeightStore (unbound)
        seed: int = 0,
        name: str = "node0",
    ):
        self.name = name
        self.loop = loop or EventLoop()
        self.registry = registry
        self.services = services or ServiceRegistry()
        self.tracker = MemoryTracker(self.loop)
        self.engines = EngineSet(
            self.loop,
            registry,
            self.services,
            num_slots=num_slots,
            comm_slots=comm_slots,
            backend=backend,
            tracker=self.tracker,
            seed=seed,
            batch_slots=batch_slots,
            batch_model=batch_model,
            batch_models=batch_models,
            max_batch=max_batch,
            replica_bytes=replica_bytes,
        )
        self.controller = PIController(
            self.engines,
            self.loop,
            interval_s=controller_interval_s,
            enabled=controller_enabled,
        )
        self.code_cache: Optional[CodeCache] = (
            CodeCache(code_cache_entries) if code_cache_entries > 0 else None
        )
        self.weight_store = weight_store
        if weight_store is not None:
            weight_store.bind(self.loop, self.tracker)
        self.dispatcher = Dispatcher(
            self.loop,
            self.engines,
            registry,
            profiles=profiles,
            max_retries=max_retries,
            default_retry=retry_policy,
            hedge_after_s=hedge_after_s,
            cache_miss_rate=cache_miss_rate,
            code_cache=self.code_cache,
            weights=weight_store,
        )
        self.num_slots = num_slots
        self.base_bytes = base_bytes
        self.latency = LatencyStats()
        self.failed_count = 0
        self.alive = True

    # -------------------------------------------------------- frontend
    def invoke(
        self,
        comp: Composition,
        inputs: SetDict,
        on_done: Optional[Callable[[InvocationRun], None]] = None,
    ) -> InvocationRun:
        """HTTP-frontend entry: schedule a composition invocation now."""
        self.controller.start()

        def done(inv: InvocationRun):
            if inv.failed:
                self.failed_count += 1
            else:
                self.latency.add(inv.latency)
            if on_done:
                on_done(inv)

        return self.dispatcher.invoke(comp, inputs, on_done=done)

    def invoke_at(
        self,
        t: float,
        comp: Composition,
        inputs: SetDict,
        on_done: Optional[Callable[[InvocationRun], None]] = None,
    ):
        self.loop.at(t, lambda: self.invoke(comp, inputs, on_done))

    def invoke_stream(self, arrivals, on_done=None):
        """Bulk trace injection: ``arrivals`` is a time-sorted iterable of
        ``(t, composition, inputs)``; replayed through a single heap
        cursor (EventLoop.at_stream) instead of one entry per event."""
        self.loop.at_stream(
            ((t, (comp, inputs)) for t, comp, inputs in arrivals),
            lambda ci: self.invoke(ci[0], ci[1], on_done),
        )

    def run(self, until: Optional[float] = None):
        self.loop.run(until=until)

    # -------------------------------------------------- fault injection
    def fail(self):
        """Node dies: every queued and in-flight task is lost, and every
        live invocation fails with "node_failure" (the cluster manager
        re-executes them on survivors - pure functions are idempotent)."""
        self.alive = False
        for q in (self.engines.compute_q, self.engines.comm_q,
                  self.engines.batch_q):
            for task in q:
                task.cancelled = True
                release_task_weights(task)  # no callback will ever fire
            q.clear()
        # in-flight tasks: their completion events will observe done flags
        for inv in list(self.dispatcher.active.values()):
            for vr in inv.vertex_runs.values():
                for inst in vr.instances:
                    inst.done = True  # suppress straggling completions
            self.dispatcher._fail(inv, "node_failure", kind=FAIL_NODE)

    # ------------------------------------------------- control-plane API
    @property
    def outstanding(self) -> int:
        """Invocations admitted to this node but not yet finished."""
        return self.dispatcher.outstanding

    def queue_delay_s(self) -> float:
        return self.dispatcher.queue_delay_s()

    def warm_fraction(self, fn_names) -> float:
        """Fraction of ``fn_names`` resident in this node's RAM code cache
        (1.0 when residency is not modeled: a shared-registry node is
        always as warm as the global RAM cache)."""
        if self.code_cache is None:
            return 1.0
        return self.code_cache.warm_fraction(fn_names)

    @property
    def committed_avg_bytes(self) -> float:
        return self.tracker.timeline.average(self.loop.now)

    @property
    def committed_peak_bytes(self) -> float:
        return self.tracker.timeline.peak()
