"""Compute and communication engines (SS5, SS6.2-6.3).

Engines abstract compute resources. Each engine slot corresponds to a CPU
core; the control plane re-types slots between "compute" and "comm"
(repro_torch.core.controller). Compute slots run exactly one task to completion
(run-to-completion, no interleaving). Comm slots are cooperative: the CPU
cost of protocol handling occupies the slot, while I/O wait does not -
one slot multiplexes up to ``max_inflight`` green tasks.

Service durations: every distinct task body actually executes its payload
(real outputs flow through the DAG); *virtual-time* durations come from
the task's calibrated ColdStartProfile when present, else from the real
measured execution. Profiled tasks take the modeled fast path: payload
execution is content-addressed-memoized (repro_torch.core.registry.PayloadMemo)
and no real disk/compile work runs, keeping full-trace sweeps faithful
AND deterministic AND cheap.

Scheduling is event-driven via per-kind idle free-lists: a submit hands
the task straight to an idle slot of that kind, and a finishing slot pulls
the next queued task directly - no O(slots) rescan per event.

Contract / determinism invariants:

  * FIFO-per-kind: tasks of one kind are served in submission order; the
    free-list heap always hands out the lowest-numbered idle slot — the
    same pairing a full slot scan produces (bit-stable benchmarks);
  * incremental ``counts()`` equals a full slot scan at every instant,
    across retypes (pinned by tests/test_sim_fastpath.py);
  * modeled durations are the only time source on the fast path: comm
    protocol CPU is derived per service, transfer cost per link
    (``coldstart.TransferProfile``) — no ``perf_counter`` on modeled
    paths, so virtual timelines are byte-stable run to run.

Cross-node scheduling adds a third task kind, ``TRANSFER``: a modeled
inter-node byte movement charged to the *sending* node's comm slots.
Like HTTP comm tasks it is cooperative — the protocol/copy CPU occupies
the slot, the wire time does not.

Serving workloads add a fourth kind, ``BATCH`` (continuous batching at
the platform layer): a batch slot models one accelerator/model replica
and coalesces every queued batchable task (up to ``max_batch``) into ONE
modeled step whose duration comes from the node's
``workloads.BatchStepModel`` roofline — the per-step weight read
amortizes over co-resident sequences, so ``step_s(8) << 8 * step_s(1)``.
Each coalesced task still executes its own payload (real token streams
flow through the DAG, identical with batching on or off); only the
virtual duration is shared. Batch slots exist only when
``batch_slots > 0`` and never retype — but unlike CPU slots they can be
*added* (``add_batch_slot``, autoscaler scale-up, optionally committing
a per-replica activation arena) and *retired* with drain-before-retire
(``retire_batch_slot``: a draining replica finishes its in-flight step
and never pulls new work — pinned by tests/test_fleet_serving.py). A
step coalesces tasks of ONE function only (multiplexed models never
share a step) and admits up to ``max_batch`` *units* — a chunked
prefill counts ``task.batch_units`` slots of the step — priced by the
per-function ``batch_models`` entry when present, else the node-level
``batch_model``. All of this collapses to the original single-model
behavior when every task has ``batch_units == 1`` and no per-function
model is registered (the byte-identity contract).

Counterpart of ``repro.core.engines``. Where an unprofiled payload is
timed for real (``_serve_compute``'s cold path, ``execute_payload``), the
card is synchronised before each clock read, so a payload that returns
with CUDA work still queued is billed its device time, not its launch
time. Modeled paths read no clock and never synchronise.
"""
from __future__ import annotations

import heapq
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.coldstart import ColdStartProfile, cold_start, sync_device
from repro_torch.core.context import MemoryContext, MemoryTracker
from repro_torch.core.http import MIN_COMM_CPU_S, SanitizationError, http_function
from repro_torch.core.items import SetDict
from repro_torch.core.registry import FunctionRegistry
from repro_torch.core.sim import EventLoop

COMPUTE, COMM = "compute", "comm"
TRANSFER = "transfer"   # modeled inter-node byte movement (comm slots)
BATCH = "batch"         # coalesced serving steps (model-replica slots)
RETIRED = "retired"     # a drained batch replica's slot id (never serves)


@dataclass(slots=True)
class Task:
    kind: str                       # compute | comm | transfer
    fn_name: str                    # registry name (compute) / "http" (comm)
    inputs: SetDict
    context_bytes: int = 1 << 20
    profile: Optional[ColdStartProfile] = None  # None -> measure real run
    warm_context: Optional[MemoryContext] = None  # keep-warm platforms
    cached: bool = True             # code in RAM cache?
    # charge the profile's cold_setup_s (non-resident state: a weight-
    # store miss, or — when no store handles the function — a code-
    # residency miss). Kept separate from ``cached`` so a code-cache
    # miss can never bill a weight load the WeightStore says is resident
    cold_setup: bool = False
    # BATCH tasks: units of the coalesced step this task occupies (a
    # chunked prefill spans several; plain decode steps span one)
    batch_units: int = 1
    timeout_s: float = 60.0
    attempts: int = 0
    cancelled: bool = False
    enqueue_t: float = 0.0
    # TRANSFER tasks: precomputed deterministic link charge
    # (TransferProfile.charge on the payload bytes)
    transfer_bytes: int = 0
    transfer_cpu_s: float = 0.0
    transfer_io_s: float = 0.0
    meta: Dict[str, Any] = field(default_factory=dict)
    on_complete: Optional[Callable[["Task", SetDict, MemoryContext], None]] = None
    on_failed: Optional[Callable[["Task", str], None]] = None


def release_task_weights(task: Task) -> None:
    """Balance a ``WeightStore.touch`` made at instance submit. Called on
    the task's single completion/failure callback, or by whoever cancels
    a task whose callbacks will never fire (``WorkerNode.fail``,
    ``Dispatcher.cancel``, the failed-invocation queue flush) — exactly
    once per submitted task (idempotent via the meta pop), so weight
    inflight counts return to zero with the invocations."""
    ws = task.meta.pop("wstore", None)
    if ws is not None:
        ws.task_done(task.fn_name)


class EngineSlot:
    def __init__(self, node: "EngineSet", slot_id: int, kind: str):
        self.node = node
        self.slot_id = slot_id
        self.kind = kind
        self.busy = False
        self.retype_to: Optional[str] = None
        self.inflight = 0           # comm green tasks in flight
        self.max_inflight = 128
        self.in_idle = False        # present (live) in node's idle list
        self.draining = False       # batch replica: retire after this step

    # ------------------------------------------------------------------
    def _serve_compute(self, task: Task):
        node = self.node
        loop = node.loop
        self.busy = True
        node.inflight_tasks.add(id(task))

        if task.warm_context is not None:
            # keep-warm platforms: sandbox already booted; execute only
            ctx = task.warm_context
            setup_s = 0.0
            outputs, exec_s = node.execute_payload(task, ctx)
        elif task.profile is not None:
            # modeled fast path, inlined from cold_start(modeled=True):
            # same context binding, same collapsed bulk commits, same
            # memoized payload execution, same record/draw order — minus
            # the breakdown object and runner closure per task
            reg = node.registry
            cf = reg.functions.get(task.fn_name) or reg.get(task.fn_name)
            ctx = MemoryContext(capacity=cf.context_bytes, tracker=node.tracker)
            ctx.bulk_load(len(cf.code), task.inputs)
            setup_s, exec_s = task.profile.sample(node.rng)
            if task.cold_setup:
                # non-resident state (model weights / code): the
                # deterministic cold term on top of the jittered base
                setup_s += task.profile.cold_setup_s
            memo = reg.memo
            outputs = memo.run(cf, ctx.inputs) if memo is not None else cf.fn(ctx.inputs)
            ctx.write_sets_bulk(outputs, into="outputs")
        else:
            ctx, bd, run = cold_start(
                node.registry,
                task.fn_name,
                task.inputs,
                backend=node.backend,
                cached=task.cached,
                tracker=node.tracker,
            )
            # the card is drained on both sides of the payload, so a payload
            # that leaves CUDA work queued is billed its device time
            sync_device()
            # det-lint: waive[wall-clock] reason=real-exec path; this branch times actual payload execution, not a model
            t0 = time.perf_counter()
            outputs = run()
            sync_device()
            # det-lint: waive[wall-clock] reason=real-exec path; this branch times actual payload execution, not a model
            exec_s = time.perf_counter() - t0
            setup_s = bd.total

        total = setup_s + exec_s
        timed_out = total > task.timeout_s
        total = min(total, task.timeout_s)
        node.stats_busy(COMPUTE, total)

        def finish():
            self.busy = False
            node.inflight_tasks.discard(id(task))
            if timed_out:
                ctx.free()
                if task.on_failed:
                    task.on_failed(task, "timeout")
            elif task.cancelled:
                ctx.free()
            else:
                for name, items in outputs.items():
                    if name not in ctx.outputs:
                        ctx.write_set(name, items, into="outputs")
                if task.on_complete:
                    task.on_complete(task, outputs, ctx)
            node.slot_available(self)

        loop.after(total, finish)

    # ------------------------------------------------------------------
    def _serve_comm(self, task: Task):
        node = self.node
        loop = node.loop
        self.busy = True
        self.inflight += 1
        node.inflight_tasks.add(id(task))

        try:
            outputs, io_s, cpu_s, idempotent = http_function(
                node.services, task.inputs
            )
            err = None
        except SanitizationError as e:
            outputs, io_s, cpu_s, idempotent = {}, 0.0, MIN_COMM_CPU_S, True
            err = f"sanitization: {e}"
        task.meta["idempotent"] = idempotent
        node.stats_busy(COMM, cpu_s)

        def cpu_done():
            # cooperative: slot is free for the next green task while this
            # one waits on I/O
            self.busy = False
            node.slot_available(self)

        def io_done():
            self.inflight -= 1
            node.inflight_tasks.discard(id(task))
            if task.cancelled:
                pass
            elif err is not None:
                if task.on_failed:
                    task.on_failed(task, err)
            else:
                ctx = MemoryContext(task.context_bytes, tracker=node.tracker)
                for name, items in task.inputs.items():
                    ctx.write_set(name, items)
                for name, items in outputs.items():
                    ctx.write_set(name, items, into="outputs")
                if task.on_complete:
                    task.on_complete(task, outputs, ctx)
            node.slot_available(self)

        loop.after(cpu_s, cpu_done)
        loop.after(cpu_s + io_s, io_done)

    # ------------------------------------------------------------------
    def _serve_transfer(self, task: Task):
        """Modeled cross-node transfer on the sending node's comm slot:
        protocol/copy CPU occupies the slot, wire time is I/O (the slot
        multiplexes other green tasks meanwhile). Durations were computed
        by the placer from the link's ``TransferProfile`` — deterministic,
        no RNG draw."""
        node = self.node
        loop = node.loop
        self.busy = True
        self.inflight += 1
        node.inflight_tasks.add(id(task))
        cpu_s, io_s = task.transfer_cpu_s, task.transfer_io_s
        node.stats_busy(COMM, cpu_s)

        def cpu_done():
            self.busy = False
            node.slot_available(self)

        def io_done():
            self.inflight -= 1
            node.inflight_tasks.discard(id(task))
            if not task.cancelled and task.on_complete:
                task.on_complete(task, {}, None)
            node.slot_available(self)

        loop.after(cpu_s, cpu_done)
        loop.after(cpu_s + io_s, io_done)

    # ------------------------------------------------------------------
    def _serve_batch(self, tasks: List[Task]):
        """One coalesced serving step over co-resident batchable tasks.

        Every task runs its own cold-start bind + payload (real outputs,
        per-task contexts, per-task setup jitter), but the execute phase
        is shared: ONE roofline step of ``batch_model.step_s(n)`` replaces
        ``n`` independent execute durations. All tasks in the step
        complete at the same virtual instant — iteration-level continuous
        batching, where a new request waits at most one step."""
        node = self.node
        loop = node.loop
        self.busy = True
        served = []
        setup_span = 0.0
        # Vectorized jitter: when every modeled task in the step shares one
        # jitter sigma (the common case — a batch coalesces instances of
        # one function), ONE numpy call draws all 2n factors the scalar
        # path would. Generator.lognormal(size=2n) is draw-for-draw
        # identical to 2n scalar calls including the final generator state
        # (pinned by tests/test_perf_identity.py), so the fast path cannot
        # perturb byte-identity; mixed-sigma steps fall back to per-task
        # sampling in the exact original order.
        n_modeled = 0
        sigma = None
        uniform = True
        for t in tasks:
            if t.profile is not None:
                n_modeled += 1
                if sigma is None:
                    sigma = t.profile.jitter_sigma
                elif t.profile.jitter_sigma != sigma:
                    uniform = False
        draws = (
            node.rng.lognormal(0.0, sigma, 2 * n_modeled)
            if uniform and n_modeled > 1
            else None
        )
        di = 0
        reg = node.registry
        memo = reg.memo
        fns = reg.functions
        tracker = node.tracker
        for task in tasks:
            node.inflight_tasks.add(id(task))
            if task.profile is not None:
                # modeled fast path, inlined from cold_start(modeled=True)
                # — identical binding/commit/draw order (see _serve_compute)
                cf = fns.get(task.fn_name) or reg.get(task.fn_name)
                ctx = MemoryContext(capacity=cf.context_bytes, tracker=tracker)
                ctx.bulk_load(len(cf.code), task.inputs)
                if draws is not None:
                    setup_s = task.profile.setup_s * float(draws[di])
                    di += 2
                else:
                    setup_s, _ = task.profile.sample(node.rng)
                if task.cold_setup:
                    setup_s += task.profile.cold_setup_s
                outputs = memo.run(cf, ctx.inputs) if memo is not None else cf.fn(ctx.inputs)
                ctx.write_sets_bulk(outputs, into="outputs")
            else:
                ctx, bd, run = cold_start(
                    node.registry,
                    task.fn_name,
                    task.inputs,
                    backend=node.backend,
                    cached=task.cached,
                    tracker=node.tracker,
                )
                setup_s = bd.total
                outputs = run()
            served.append((task, ctx, outputs, setup_s))
            if setup_s > setup_span:
                setup_span = setup_s

        units = 0
        for task in tasks:
            units += task.batch_units
        model = node.batch_models.get(tasks[0].fn_name) or node.batch_model
        step_s = model.step_s(units)
        node.batch_inflight_units += units
        total = setup_span + step_s
        node.stats_busy(BATCH, total)

        def finish():
            self.busy = False
            node.batch_inflight_units -= units
            for task, ctx, outputs, setup_s in served:
                node.inflight_tasks.discard(id(task))
                # same timeout contract as the compute path (a task whose
                # own setup + the shared step exceed its budget fails);
                # the callback fires at batch end rather than at the
                # timeout instant — the outcome, not the timing, is what
                # the batching-on/off invariant guarantees
                if setup_s + step_s > task.timeout_s:
                    ctx.free()
                    if task.on_failed:
                        task.on_failed(task, "timeout")
                elif task.cancelled:
                    ctx.free()
                else:
                    for name, items in outputs.items():
                        if name not in ctx.outputs:
                            ctx.write_set(name, items, into="outputs")
                    if task.on_complete:
                        task.on_complete(task, outputs, ctx)
            node.slot_available(self)

        loop.after(total, finish)


class EngineSet:
    """All engine slots of one worker node + the two typed queues.

    Idle-slot scheduling: per-kind free-lists give O(1) submit->slot
    handoff and finish->next-task pull, with incremental slot-kind
    counters for the controller (no per-tick O(slots) scans)."""

    def __init__(
        self,
        loop: EventLoop,
        registry: FunctionRegistry,
        services,
        *,
        num_slots: int = 8,
        comm_slots: int = 1,
        backend: str = "dandelion",
        tracker: Optional[MemoryTracker] = None,
        seed: int = 0,
        batch_slots: int = 0,
        batch_model=None,            # workloads.BatchStepModel (required
                                     # when batch_slots > 0)
        batch_models=None,           # per-fn {fn_name: BatchStepModel}
                                     # overrides for multiplexed models
        max_batch: int = 32,
        replica_bytes: int = 0,      # per-replica activation arena,
                                     # committed while the replica is up
    ):
        self.loop = loop
        self.registry = registry
        self.services = services
        self.backend = backend
        self.tracker = tracker or MemoryTracker(loop)
        self.rng = np.random.default_rng(seed)
        self.compute_q: deque = deque()
        self.comm_q: deque = deque()
        self.batch_q: deque = deque()
        if batch_slots > 0 and batch_model is None and not batch_models:
            raise ValueError("batch slots need a BatchStepModel")
        self.batch_slots = batch_slots
        self.batch_model = batch_model
        self.batch_models: Dict[str, Any] = dict(batch_models or {})
        self.max_batch = max_batch
        self.replica_bytes = replica_bytes
        self.batch_inflight_units = 0   # units inside in-flight steps
        self._batch_draining = 0        # replicas marked, not yet retired
        # liveness hook (set by ReplicaAutoscaler.start): called
        # synchronously when batchable work queues with ZERO active
        # replicas, so the scale-up boot — a non-daemon event — keeps
        # the loop alive instead of stranding the task behind a tick
        # that only fires while something else is scheduled
        self.on_batch_starved: Optional[Callable[[], None]] = None
        self.replicas_added = 0
        self.replicas_retired = 0
        self.slots: List[EngineSlot] = []
        # per-kind idle free-lists: min-heaps of slot ids, so dispatch
        # always picks the lowest-numbered idle slot (the same assignment
        # the old full scan produced, kept for bit-stable benchmarks)
        self._idle: Dict[str, List[int]] = {COMPUTE: [], COMM: [], BATCH: []}
        self._counts: Dict[str, int] = {COMPUTE: 0, COMM: 0, BATCH: 0}
        for i in range(num_slots):
            kind = COMM if i < comm_slots else COMPUTE
            s = EngineSlot(self, i, kind)
            self.slots.append(s)
            self._counts[kind] += 1
            s.in_idle = True
            self._idle[kind].append(i)
        # batch slots (model replicas) come AFTER the CPU slots so the
        # compute/comm slot numbering — and therefore every existing
        # benchmark's slot pairing — is untouched; they never retype
        for i in range(num_slots, num_slots + batch_slots):
            s = EngineSlot(self, i, BATCH)
            self.slots.append(s)
            self._counts[BATCH] += 1
            s.in_idle = True
            self._idle[BATCH].append(i)
        if replica_bytes and batch_slots:
            self.tracker.commit(replica_bytes * batch_slots)
        self.busy_s = {COMPUTE: 0.0, COMM: 0.0, BATCH: 0.0}
        self._arrivals = {COMPUTE: 0, COMM: 0, BATCH: 0}
        self.inflight_tasks: set = set()
        # EWMA of time tasks sat queued before a slot picked them up - the
        # signal the elastic control plane scales on (Dirigent-style)
        self.queue_delay_ewma = {COMPUTE: 0.0, COMM: 0.0, BATCH: 0.0}
        self._qdelay_alpha = 0.2

    # ------------------------------------------------------------------
    def queue(self, kind: str) -> deque:
        """Queue serving ``kind``; TRANSFER shares the comm queue (and
        therefore comm slots and FIFO order with HTTP tasks)."""
        if kind == COMPUTE:
            return self.compute_q
        if kind == BATCH:
            return self.batch_q
        return self.comm_q

    def submit(self, task: Task):
        task.enqueue_t = self.loop.now
        if task.kind == COMPUTE:
            slot_kind = COMPUTE
        elif task.kind == BATCH:
            slot_kind = BATCH
        else:
            slot_kind = COMM
        self.queue(slot_kind).append(task)
        self._arrivals[slot_kind] += 1
        self._dispatch(slot_kind)

    # ----------------------------------------------------- idle-slot core
    def _pop_idle(self, kind: str) -> Optional[EngineSlot]:
        idle = self._idle[kind]
        while idle:
            s = self.slots[heapq.heappop(idle)]
            if not s.in_idle or s.kind != kind or s.busy:
                continue  # stale entry left behind by a slot retype
            s.in_idle = False
            return s
        return None

    def _serve(self, slot: EngineSlot, kind: str, task: Task):
        self.note_queue_delay(kind, self.loop.now - task.enqueue_t)
        if task.kind == COMPUTE:
            slot._serve_compute(task)
        elif task.kind == TRANSFER:
            slot._serve_transfer(task)
        else:
            slot._serve_comm(task)

    def _dispatch(self, kind: str):
        """Pair queued tasks of ``kind`` with idle slots (FIFO on both)."""
        q = self.queue(kind)
        while q:
            if q[0].cancelled:
                q.popleft()
                continue
            slot = self._pop_idle(kind)
            if slot is None:
                if (kind == BATCH and self.on_batch_starved is not None
                        and self.active_batch_slots() == 0):
                    self.on_batch_starved()
                return
            if kind == BATCH:
                self._serve_batch_slot(slot)
            else:
                self._serve(slot, kind, q.popleft())

    def _serve_batch_slot(self, slot: EngineSlot):
        """Coalesce the FIFO prefix of same-function queued tasks (up to
        ``max_batch`` units) into one modeled step on ``slot``. Tasks of
        a different function stay queued for the next step — multiplexed
        models never share one accelerator step. With one model and
        unit tasks this selects exactly the original FIFO prefix."""
        q = self.batch_q
        tasks: List[Task] = []
        units = 0
        key = None
        while q and units < self.max_batch:
            task = q[0]
            if task.cancelled:
                q.popleft()
                continue
            if key is None:
                key = task.fn_name
            elif task.fn_name != key:
                break
            if tasks and units + task.batch_units > self.max_batch:
                break       # next task would overflow the step
            q.popleft()
            self.note_queue_delay(BATCH, self.loop.now - task.enqueue_t)
            tasks.append(task)
            units += task.batch_units
        if not tasks:       # everything queued had been cancelled
            slot.in_idle = True
            heapq.heappush(self._idle[BATCH], slot.slot_id)
            return
        slot._serve_batch(tasks)

    def slot_available(self, slot: EngineSlot):
        """A slot finished (or freed its CPU phase): apply any pending
        retype, then pull the next queued task directly, else go idle."""
        if slot.busy:
            return
        if slot.draining:
            # drain-before-retire: the replica's last step just finished
            # (or it was idle); it leaves the pool without pulling work
            self._finish_retire(slot)
            return
        if slot.retype_to and slot.inflight == 0:
            # the slot may sit in its old kind's free-list (idle comm slot
            # with I/O in flight); logically remove that entry or the
            # in_idle guard below would keep the slot out of the new pool
            slot.in_idle = False
            slot.kind = slot.retype_to
            slot.retype_to = None
            self._counts[slot.kind] += 1
        kind = slot.kind
        if kind == COMM and slot.inflight >= slot.max_inflight:
            return
        q = self.queue(kind)
        while q and q[0].cancelled:
            q.popleft()
        if q and kind == BATCH:
            self._serve_batch_slot(slot)
        elif q:
            self._serve(slot, kind, q.popleft())
        elif not slot.in_idle:
            slot.in_idle = True
            heapq.heappush(self._idle[kind], slot.slot_id)

    def _models_batching(self) -> bool:
        """Whether this node models a batching engine at all. Per-fn
        ``batch_models`` declares elastic capability — it stays True while
        the replica pool is scaled to zero (slot count is load state, not
        capability), so batchable work queues where the autoscaler sees
        it. The legacy single ``batch_model`` only batches while slots
        exist (byte-identity: such nodes historically fell back to the
        COMPUTE engine at ``batch_slots=0``)."""
        return self.batch_slots > 0 or bool(self.batch_models)

    def poke(self):
        """Re-sync queues with idle slots (O(1) when queues are empty)."""
        self._dispatch(COMPUTE)
        self._dispatch(COMM)
        if self.batch_slots:
            self._dispatch(BATCH)

    def stats_busy(self, kind: str, seconds: float):
        self.busy_s[kind] += seconds

    def note_queue_delay(self, kind: str, delay_s: float):
        a = self._qdelay_alpha
        self.queue_delay_ewma[kind] = (
            (1 - a) * self.queue_delay_ewma[kind] + a * max(0.0, delay_s)
        )

    # ----------------------------------------------------- controller API
    def counts(self) -> Dict[str, int]:
        """Slots per kind (excluding retype-pending), maintained
        incrementally - the controller ticks every 30ms. The BATCH entry
        appears only on nodes that model a batching engine, so platforms
        without one keep their pre-serving dict shape."""
        c = {COMPUTE: self._counts[COMPUTE], COMM: self._counts[COMM]}
        if self._models_batching():
            c[BATCH] = self._counts[BATCH]
        return c

    def queue_lengths(self) -> Dict[str, int]:
        q = {COMPUTE: len(self.compute_q), COMM: len(self.comm_q)}
        if self._models_batching():
            q[BATCH] = len(self.batch_q)
        return q

    def retype_one(self, frm: str, to: str) -> bool:
        """Move one slot between engine types (finishes current task first)."""
        if self._counts[frm] <= 1:
            return False
        for s in self.slots:
            if s.kind == frm and not s.retype_to:
                self._counts[frm] -= 1
                if s.busy or s.inflight:
                    s.retype_to = to
                else:
                    # idle slot: logically leave the old free-list (its
                    # entry goes stale), flip kind, join the new pool
                    s.in_idle = False
                    s.kind = to
                    self._counts[to] += 1
                    self.slot_available(s)
                return True
        return False

    # ----------------------------------------------- replica lifecycle
    def add_batch_slot(self) -> int:
        """Bring one more BATCH replica online (autoscaler scale-up).
        The new slot takes the next slot id, so CPU slot numbering —
        and every static benchmark's slot pairing — is untouched. Any
        ``replica_bytes`` activation arena commits while the replica is
        up. Queued batch work dispatches to it immediately."""
        if self.batch_model is None and not self.batch_models:
            raise ValueError("batch replicas need a BatchStepModel")
        i = len(self.slots)
        s = EngineSlot(self, i, BATCH)
        self.slots.append(s)
        self._counts[BATCH] += 1
        self.batch_slots += 1
        self.replicas_added += 1
        if self.replica_bytes:
            self.tracker.commit(self.replica_bytes)
        s.in_idle = True
        heapq.heappush(self._idle[BATCH], i)
        self._dispatch(BATCH)
        return i

    def retire_batch_slot(self) -> bool:
        """Drain-before-retire one BATCH replica. An idle replica leaves
        immediately; a busy one finishes its in-flight coalesced step
        and then leaves — a draining replica never pulls new work.
        Prefers an idle replica, highest slot id first (LIFO, mirroring
        scale-up order). Returns False when no replica is retirable."""
        idle_pick = busy_pick = None
        for s in reversed(self.slots):
            if s.kind != BATCH or s.draining:
                continue
            if not s.busy:
                if idle_pick is None:
                    idle_pick = s
            elif busy_pick is None:
                busy_pick = s
        s = idle_pick or busy_pick
        if s is None:
            return False
        s.draining = True
        self._batch_draining += 1
        if not s.busy:
            self._finish_retire(s)
        return True

    def _finish_retire(self, s: EngineSlot):
        # the slot id stays allocated (stable numbering; stale free-list
        # entries are skipped by the _pop_idle kind check) but the slot
        # can never serve again
        s.draining = False
        s.in_idle = False
        s.kind = RETIRED
        self._batch_draining -= 1
        self._counts[BATCH] -= 1
        self.batch_slots -= 1
        self.replicas_retired += 1
        if self.replica_bytes:
            self.tracker.release(self.replica_bytes)
        # the pool may have drained to zero with work still queued (the
        # retired replica was the last): same liveness kick as _dispatch
        if (self.on_batch_starved is not None
                and self.active_batch_slots() == 0
                and any(not t.cancelled for t in self.batch_q)):
            self.on_batch_starved()

    def active_batch_slots(self) -> int:
        """BATCH replicas that will still pull new work (not draining)."""
        return self._counts[BATCH] - self._batch_draining

    def batch_queued_units(self) -> int:
        """Live units waiting in the batch queue (the autoscaler's and
        router's backlog signal; O(queue), called per tick not per event)."""
        return sum(t.batch_units for t in self.batch_q if not t.cancelled)

    def execute_payload(self, task: Task, ctx: MemoryContext):
        """Warm-start execution (no cold-start phases)."""
        cf = self.registry.get(task.fn_name)
        for name, items in task.inputs.items():
            ctx.write_set(name, items)
        if task.profile is not None:
            _, exec_s = task.profile.sample(self.rng)
            outputs = self.registry.run_payload(task.fn_name, task.inputs)
        else:
            sync_device()  # as in _serve_compute: bill device time
            # det-lint: waive[wall-clock] reason=real-exec path; unprofiled payloads run for real and are timed
            t0 = time.perf_counter()
            outputs = cf.fn(task.inputs)
            sync_device()
            # det-lint: waive[wall-clock] reason=real-exec path; unprofiled payloads run for real and are timed
            exec_s = time.perf_counter() - t0
        return outputs, exec_s
