"""Cluster manager + cross-node placement + keep-warm baseline platform.

``ClusterManager`` plays Dirigent's role (SS5): it load-balances
composition invocations over Dandelion worker nodes, injects/handles node
failures (pure functions are idempotent, so lost invocations restart on a
surviving node), supports elastic node add/remove, and aggregates memory /
latency accounting.

``CrossNodePlacer`` is the cross-node composition scheduler (default-off,
enabled with ``crossnode=True`` or the ``CROSSNODE=1`` environment knob):
the dispatcher of the routed *home* node exports each ready DAG vertex
back to the cluster layer, which may place it on a different node —
vertex-granular elasticity instead of whole-request pinning. Placement
policy is ``ElasticControlPlane.place_vertex`` (code-cache affinity +
p2c, journaled) when a control plane owns the pool, else a deterministic
warmest-then-least-loaded scan over the static node list. Every edge
whose producer executed on a different node than the consumer is charged
exactly one modeled transfer task (``engines.TRANSFER``) on the
*producing* node's comm engine, sized from the edge payload's item bytes
with latency/bandwidth from the per-link ``coldstart.TransferProfile``;
the in-flight bytes are staged in a ``MemoryContext`` whose ownership
moves from sender to receiver tracker when the wire time elapses.

``KeepWarmPlatform`` is the baseline execution model (Firecracker/
Knative): single-function requests served by a per-function sandbox pool.
Two modes:
  * forced ``hot_ratio`` (the paper's 97%-hot microbenchmark setting);
  * ``autoscale=True``: Knative-style concurrency autoscaler with panic
    window + keep-alive reaping (the Azure-trace experiment).
Sandboxes commit context + guest-OS memory while alive - the
over-provisioning Figures 1/10 quantify.

Contract / determinism invariants:

  * with cross-node placement disabled (the default) no placer is
    attached and the dispatch path is byte-identical to the single-node
    platform — fig10/fig11 outputs do not move;
  * transfer durations are deterministic (``TransferProfile.charge``, no
    jitter), so cross-node runs are byte-stable given seed + workload;
  * staging contexts ride the dispatcher's freed-exactly-once lifecycle
    (they join ``VertexRun.contexts``), including on failure mid-flight
    (pinned by tests/test_crossnode.py);
  * node failure stays whole-invocation: a dying node fails its own
    homed invocations (``WorkerNode.fail``) AND — via
    ``CrossNodePlacer.on_node_failure`` — every live invocation homed
    elsewhere that placed vertices or in-flight transfers on it; the
    cluster restart path re-executes them on survivors. Use
    ``ClusterManager.fail_node_at`` (not ``WorkerNode.fail`` directly)
    in cross-node runs so the placer is notified.
"""
from __future__ import annotations

import itertools
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.coldstart import ColdStartProfile, TransferProfile
from repro_torch.core.context import MemoryContext, MemoryTracker
from repro_torch.core.dag import COMPUTE, Composition
from repro_torch.core.dispatcher import (
    FAIL_CANCELLED, FAIL_NODE, Dispatcher, InvocationRun, VertexRun,
)
from repro_torch.core.engines import TRANSFER, Task
from repro_torch.core.items import SetDict, set_bytes
from repro_torch.core.node import WorkerNode
from repro_torch.core.sim import EventLoop
from repro_torch.core.tracing import LatencyStats, TransferStats


class CrossNodePlacer:
    """Vertex-granular cluster scheduler (the paper's SS4/SS5 elasticity
    claim taken past whole-request granularity).

    Attached to every worker node's dispatcher; ``place`` is called once
    per ready vertex. Compute vertices may be placed on any alive node;
    comm vertices and nested subgraphs stay on the home node (their
    engines multiplex I/O, so moving them buys nothing but transfers).
    Remote placement wires up:

      * the vertex's instances run on the target node's engines and warm
        the *target* node's code cache;
      * one ``TRANSFER`` task per crossing in-edge (and per composition
        input binding feeding a remotely placed root vertex), charged to
        the producing node's comm engine with deterministic durations
        from the link's ``TransferProfile``;
      * a staging ``MemoryContext`` per transfer holding the in-flight
        items: committed on the sender while on the wire, ownership
        transferred to the receiver on arrival, freed through the
        consumer vertex's normal context lifecycle;
      * a remote-input barrier: the vertex launches only when all its
        inbound transfers have landed (``Dispatcher.launch_placed``).
    """

    def __init__(
        self,
        cluster: "ClusterManager",
        *,
        links: Optional[Dict[Tuple[str, str], TransferProfile]] = None,
        default_link: Optional[TransferProfile] = None,
        spread_instances: bool = False,
    ):
        self.cluster = cluster
        self.links = dict(links or {})
        self.default_link = default_link or TransferProfile()
        self.spread_instances = spread_instances
        self.stats = TransferStats()
        self._home: Dict[int, WorkerNode] = {}   # dispatcher id -> node
        self._vload: Dict[int, int] = {}         # node id -> placed vertices
        # node id -> {id(inv): (home dispatcher, inv)} for invocations with
        # vertices or in-flight transfers on that node: a dying node must
        # fail them (their home dispatcher would otherwise wait forever on
        # work the dead node silently dropped)
        self._deps: Dict[int, Dict[int, Tuple[Dispatcher, InvocationRun]]] = {}
        self._deps_prune_at: Dict[int, int] = {}

    # ------------------------------------------------------------------
    def attach(self, node: WorkerNode):
        """Register ``node``'s dispatcher: ready vertices flow back here."""
        self._home[id(node.dispatcher)] = node
        node.dispatcher.placer = self

    def link(self, src_name: str, dst_name: str) -> TransferProfile:
        return self.links.get((src_name, dst_name), self.default_link)

    def vertex_load(self, node: WorkerNode) -> int:
        return self._vload.get(id(node), 0)

    def _depend(self, node: WorkerNode, disp: Dispatcher, inv: InvocationRun):
        d = self._deps.setdefault(id(node), {})
        if id(inv) not in d:
            d[id(inv)] = (disp, inv)
            # geometric compaction: sweep settled invocations only once
            # the dict doubles past the last sweep's live size, so each
            # O(n) scan is paid for by n inserts (amortized O(1) even
            # when every entry is live)
            if len(d) >= self._deps_prune_at.get(id(node), 4096):
                for k in [k for k, (_, i) in d.items() if i.done or i.failed]:
                    del d[k]
                self._deps_prune_at[id(node)] = max(4096, 2 * len(d))

    def on_node_failure(self, node: WorkerNode):
        """``node`` died: fail every live invocation (homed elsewhere)
        that has vertices placed on it or transfers touching it; the
        cluster's restart-on-survivor path re-executes them."""
        for disp, inv in list(self._deps.pop(id(node), {}).values()):
            if not inv.done and not inv.failed:
                disp._fail(inv, "node_failure", kind=FAIL_NODE)

    # ---------------------------------------------------------- policy
    def _pick(self, fn_name: str, home: WorkerNode) -> WorkerNode:
        cp = self.cluster.control_plane
        if cp is not None:
            return cp.place_vertex(fn_name, home, self.vertex_load)
        alive = [n for n in self.cluster._nodes if n.alive]
        if len(alive) <= 1:
            return alive[0] if alive else home

        def key(i_n):
            i, n = i_n
            load = self.cluster._outstanding.get(id(n), 0) + self.vertex_load(n)
            # warmest code cache first, then least loaded; ties keep the
            # vertex home (no transfer charge), then stable node order
            return (-n.warm_fraction((fn_name,)), load, n is not home, i)

        return min(enumerate(alive), key=key)[1]

    # ------------------------------------------------------- placement
    def place(self, disp: Dispatcher, inv: InvocationRun, vr: VertexRun) -> bool:
        """Place one ready vertex. Returns True iff the vertex is waiting
        behind a remote-input barrier (the placer resumes the launch);
        False means the dispatcher proceeds immediately (locally or on
        the target's engines with no inbound transfers)."""
        v = vr.vertex
        home = self._home[id(disp)]
        if v.kind == COMPUTE:
            if (self.spread_instances and vr.tmpl is not None
                    and vr.tmpl.fan_edge is not None):
                # each/key fan-outs spread per *instance* (see spread()):
                # the vertex anchors home so downstream edge accounting
                # sees its merged outputs at the home node — remote
                # instances gather their outputs back explicitly
                target = home
            else:
                target = self._pick(v.function, home)
        else:
            # comm vertices run on the home comm engines and subgraphs
            # unfold on the home dispatcher (their inner vertices get
            # placed individually), but either may still need remote
            # producers' outputs pulled back first (charged below)
            target = home
        vr.exec_node = target
        if target is home:
            self.stats.local_placements += 1
        else:
            self.stats.remote_placements += 1
            self._vload[id(target)] = self._vload.get(id(target), 0) + 1
            self._depend(target, disp, inv)
            vr.exec_engines = target.engines
            vr.exec_code_cache = target.code_cache
            vr.exec_weights = target.weight_store

            def release():
                self._vload[id(target)] -= 1
                cp = self.cluster.control_plane
                if cp is not None and self._vload[id(target)] == 0:
                    cp.on_vertex_complete(target)

            vr.placed_release = release

        # one transfer per data dependency that crosses nodes: in-edges
        # whose producer executed on a different node than this vertex,
        # and composition inputs (they arrived at the home frontend) when
        # the vertex itself moved away from home
        transfers: List[Tuple[WorkerNode, list]] = []
        for e in inv.comp.in_edges(v.name):
            up = inv.vertex_runs[e.src.vertex]
            src = up.exec_node or home
            if src is not target:
                transfers.append((src, up.outputs.get(e.src.set_name, [])))
        if target is not home:
            for in_name, port in inv.comp.input_bindings.items():
                if port.vertex == v.name:
                    transfers.append((home, inv.inputs.get(in_name, [])))
        if not transfers:
            return False
        vr.barrier = len(transfers)
        for src, items in transfers:
            self._charge(disp, inv, vr, src, target, items)
        return True

    def _charge(self, disp: Dispatcher, inv: InvocationRun, vr: VertexRun,
                src: WorkerNode, dst: WorkerNode, items: list):
        nbytes = set_bytes(items)
        cpu_s, io_s = self.link(src.name, dst.name).charge(nbytes)
        self.stats.record_transfer(src.name, dst.name, nbytes, cpu_s, io_s)
        self._depend(src, disp, inv)   # sender death must fail the barrier
        # stage the in-flight bytes on the sender; freed exactly once at
        # the consuming vertex's completion or invocation failure
        stage = MemoryContext(capacity=max(nbytes, 1), tracker=src.tracker)
        if items:
            stage.write_set("payload", items)
        vr.staged.append(stage)

        def arrived(task: Task, outputs, _ctx):
            stage.transfer_ownership(dst.tracker)   # no-op if already freed
            vr.barrier -= 1
            if inv.failed:
                return
            if vr.barrier == 0:
                disp.launch_placed(inv, vr)

        src.engines.submit(Task(
            kind=TRANSFER, fn_name="transfer", inputs={}, context_bytes=0,
            transfer_bytes=nbytes, transfer_cpu_s=cpu_s, transfer_io_s=io_s,
            on_complete=arrived,
        ))

    # ------------------------------------------------ instance spreading
    def spread(self, disp: Dispatcher, inv: InvocationRun, vr: VertexRun):
        """Scatter a fan-out vertex's instances across alive nodes so an
        ``each``/``key`` expansion can saturate the cluster instead of
        landing on one node (scatter-gather semantics: each remote
        instance's inputs are charged as a transfer home->target, its
        outputs as a transfer target->home before the instance counts as
        done, so ``vr.exec_node`` stays home and downstream edges are
        accounted exactly as if the vertex ran locally).

        Picks are deterministic — least placed-load with per-call
        assignment counts, ties prefer home then stable node order — no
        RNG. Retries and hedges of a spread instance resubmit on the
        home node (fallback-to-home). A target's death fails the whole
        invocation through the normal ``_depend`` path."""
        home = self._home[id(disp)]
        cp = self.cluster.control_plane
        if cp is not None:
            alive = cp.active_nodes
        else:
            alive = [n for n in self.cluster._nodes if n.alive]
        if len(alive) <= 1:
            for inst in vr.instances:
                disp._submit_instance(inv, vr, inst)
            return
        assigned: Dict[int, int] = {}
        pending: Dict[int, WorkerNode] = {}    # inst idx -> remote node

        def release_one(idx: int):
            n = pending.pop(idx, None)
            if n is None:
                return
            self._vload[id(n)] -= 1
            if cp is not None and self._vload[id(n)] == 0:
                cp.on_vertex_complete(n)

        def release_all():
            for idx in list(pending):
                release_one(idx)

        vr.placed_release = release_all

        for inst in vr.instances:
            target = min(
                enumerate(alive),
                key=lambda i_n: (
                    self.vertex_load(i_n[1]) + assigned.get(id(i_n[1]), 0),
                    i_n[1] is not home,
                    i_n[0],
                ),
            )[1]
            assigned[id(target)] = assigned.get(id(target), 0) + 1
            if target is home:
                self.stats.local_placements += 1
                disp._submit_instance(inv, vr, inst)
                continue
            self.stats.remote_placements += 1
            self._vload[id(target)] = self._vload.get(id(target), 0) + 1
            pending[inst.idx] = target
            self._depend(target, disp, inv)
            self._scatter(disp, inv, vr, inst, home, target, release_one)

    def _scatter(self, disp: Dispatcher, inv: InvocationRun, vr: VertexRun,
                 inst, home: WorkerNode, target: WorkerNode,
                 release_one: Callable[[int], None]):
        """Move one instance's inputs home->target, then run it there;
        arm the gather-back on completion."""
        items = [it for iset in inst.inputs.values() for it in iset]
        nbytes = set_bytes(items)
        cpu_s, io_s = self.link(home.name, target.name).charge(nbytes)
        self.stats.record_transfer(home.name, target.name, nbytes, cpu_s, io_s)
        stage = MemoryContext(capacity=max(nbytes, 1), tracker=home.tracker)
        if items:
            stage.write_set("payload", items)
        vr.staged.append(stage)

        def arrived(_task: Task, _outputs, _ctx):
            stage.transfer_ownership(target.tracker)
            if inv.failed:
                release_one(inst.idx)
                return
            task = disp._submit_instance(inv, vr, inst, remote=target)
            self._arm_gather(disp, inv, vr, inst, task, home, target,
                             release_one)

        home.engines.submit(Task(
            kind=TRANSFER, fn_name="transfer", inputs={}, context_bytes=0,
            transfer_bytes=nbytes, transfer_cpu_s=cpu_s, transfer_io_s=io_s,
            on_complete=arrived,
        ))

    def _arm_gather(self, disp: Dispatcher, inv: InvocationRun, vr: VertexRun,
                    inst, task: Task, home: WorkerNode, target: WorkerNode,
                    release_one: Callable[[int], None]):
        """Wrap the remote task's callbacks: its outputs travel back to
        the home node (one charged transfer) before the instance counts
        as complete; failures release the placement and take the normal
        retry path (which resubmits at home)."""

        def done(t: Task, outputs, ctx):
            if inv.failed or inst.done:
                # dead invocation / hedge loser: no gather to charge —
                # the normal completion path just frees the context
                release_one(inst.idx)
                disp._on_task_complete(t, outputs, ctx)
                return
            items = [it for iset in outputs.values() for it in iset]
            gbytes = set_bytes(items)
            cpu_s, io_s = self.link(target.name, home.name).charge(gbytes)
            self.stats.record_transfer(target.name, home.name, gbytes,
                                       cpu_s, io_s)
            stage = MemoryContext(capacity=max(gbytes, 1),
                                  tracker=target.tracker)
            if items:
                stage.write_set("payload", items)
            vr.staged.append(stage)

            def landed(_t: Task, _o, _c):
                stage.transfer_ownership(home.tracker)
                release_one(inst.idx)
                disp._on_task_complete(t, outputs, ctx)

            target.engines.submit(Task(
                kind=TRANSFER, fn_name="transfer", inputs={},
                context_bytes=0, transfer_bytes=gbytes,
                transfer_cpu_s=cpu_s, transfer_io_s=io_s,
                on_complete=landed,
            ))

        def failed(t: Task, reason: str):
            release_one(inst.idx)
            disp._on_task_failed(t, reason)

        task.on_complete = done
        task.on_failed = failed


class ClusterManager:
    """Cluster frontend. Routing/scaling either static (least-outstanding
    over a fixed node list) or delegated to an ``ElasticControlPlane``;
    failure-restart semantics (idempotent re-execution on survivors) live
    here in both modes. ``crossnode=True`` (or ``CROSSNODE=1`` in the
    environment) enables vertex-granular cross-node scheduling via
    ``CrossNodePlacer``."""

    def __init__(
        self,
        nodes: Optional[List[WorkerNode]] = None,
        loop: Optional[EventLoop] = None,
        *,
        control_plane=None,   # repro_torch.core.control_plane.ElasticControlPlane
        crossnode: Optional[bool] = None,   # None -> CROSSNODE env knob
        crossnode_spread: Optional[bool] = None,  # None -> CROSSNODE_SPREAD
        transfer_links: Optional[Dict[Tuple[str, str], TransferProfile]] = None,
        transfer_profile: Optional[TransferProfile] = None,
        restart_attempts: int = 3,   # node-death re-executions per request
        route_policy: str = "outstanding",  # "outstanding" | "batch_aware"
        batch_router=None,   # control_plane.BatchRouter override
        distributor=None,    # artifacts.P2PDistributor: P2P prefetch on join
    ):
        if restart_attempts < 0:
            raise ValueError(
                f"restart_attempts must be >= 0, got {restart_attempts}"
            )
        self.restart_attempts = restart_attempts
        self.control_plane = control_plane
        if control_plane is not None:
            if nodes:
                raise ValueError(
                    "pass nodes OR control_plane, not both; the control "
                    "plane owns the pool (use add_node/adopt for extras)"
                )
            self.loop = loop or control_plane.loop
            self._nodes: List[WorkerNode] = []
        else:
            if not nodes:
                raise ValueError("cluster needs at least one node")
            if loop is None:
                raise ValueError("static cluster needs an explicit loop")
            self.loop = loop
            self._nodes = list(nodes)
        self.latency = LatencyStats()
        self.restarts = 0
        self.failed = 0
        self.cancelled = 0
        self._outstanding: Dict[int, int] = {id(n): 0 for n in self._nodes}
        if route_policy not in ("outstanding", "batch_aware"):
            raise ValueError(f"unknown route_policy {route_policy!r}")
        self.batch_router = batch_router
        if route_policy == "batch_aware" and self.batch_router is None:
            from repro_torch.core.control_plane import BatchRouter
            self.batch_router = BatchRouter()
        self.distributor = distributor
        if distributor is not None and self.control_plane is not None \
                and self.control_plane.distributor is None:
            self.control_plane.distributor = distributor
        if crossnode is None:
            crossnode = os.environ.get("CROSSNODE") == "1"
        if crossnode_spread is None:
            crossnode_spread = os.environ.get("CROSSNODE_SPREAD") == "1"
        self.placer: Optional[CrossNodePlacer] = None
        if crossnode:
            self.placer = CrossNodePlacer(
                self, links=transfer_links, default_link=transfer_profile,
                spread_instances=crossnode_spread,
            )
            if self.control_plane is not None:
                self.control_plane.placer = self.placer
                for n in self.control_plane.worker_nodes:
                    self.placer.attach(n)
            else:
                for n in self._nodes:
                    self.placer.attach(n)

    @property
    def nodes(self) -> List[WorkerNode]:
        if self.control_plane is not None:
            return self.control_plane.worker_nodes
        return self._nodes

    # ------------------------------------------------------------ routing
    def _route(self, comp: Composition) -> WorkerNode:
        if self.control_plane is not None:
            return self.control_plane.route(comp)
        alive = [n for n in self._nodes if n.alive]
        if not alive:
            raise RuntimeError("no alive nodes")
        if self.batch_router is not None:
            # marginal-latency routing over batch replicas; compositions
            # with no batchable work fall through to least-outstanding
            picked = self.batch_router.pick(
                alive, comp, alive[0].registry,
                load=lambda n: self._outstanding[id(n)],
            )
            if picked is not None:
                return picked
        return min(alive, key=lambda n: self._outstanding[id(n)])

    def invoke(
        self,
        comp: Composition,
        inputs: SetDict,
        on_done: Optional[Callable[[InvocationRun], None]] = None,
        _attempt: int = 0,
        on_start: Optional[Callable[[InvocationRun], None]] = None,
    ) -> InvocationRun:
        """Route and admit one invocation; returns the live
        ``InvocationRun``. ``on_start`` fires for every admission —
        including node-death re-executions — with the (new) live run, so
        callers holding a handle can track/cancel the current attempt."""
        node = self._route(comp)
        if self.control_plane is not None:
            self.control_plane.on_dispatch(node)
        else:
            self._outstanding[id(node)] += 1
        t_submit = self.loop.now

        def done(inv: InvocationRun):
            if self.control_plane is not None:
                self.control_plane.on_complete(node)
            else:
                self._outstanding[id(node)] -= 1
            # structured failure kind, not a reason-substring match: a
            # user vertex named "node_failure" must not restart, and a
            # cancelled request must never be resurrected
            if (
                inv.failure_kind == FAIL_NODE
                and _attempt < self.restart_attempts
            ):
                # idempotent re-execution on a surviving node (SS6.1)
                self.restarts += 1
                self.invoke(comp, inputs, on_done, _attempt=_attempt + 1,
                            on_start=on_start)
                return
            if inv.failure_kind == FAIL_CANCELLED:
                self.cancelled += 1
            elif inv.failed:
                self.failed += 1
            else:
                self.latency.add(self.loop.now - t_submit)
            if on_done:
                on_done(inv)

        inv = node.invoke(comp, inputs, on_done=done)
        # a synchronously finished run is never the caller's live attempt
        # (a restart's recursive invoke already reported the newer one)
        if on_start is not None and not inv.done and not inv.failed:
            on_start(inv)
        return inv

    def invoke_at(self, t: float, comp: Composition, inputs: SetDict,
                  on_done=None):
        self.loop.at(t, lambda: self.invoke(comp, inputs, on_done))

    def invoke_stream(self, arrivals, on_done=None):
        """Bulk trace injection: time-sorted ``(t, comp, inputs)`` triples
        replayed through one heap cursor (see EventLoop.at_stream)."""
        self.loop.at_stream(
            ((t, (comp, inputs)) for t, comp, inputs in arrivals),
            lambda ci: self.invoke(ci[0], ci[1], on_done),
        )

    # ------------------------------------------------------ elasticity
    def add_node(self, node: WorkerNode):
        if self.control_plane is not None:
            self.control_plane.adopt(node)   # adopt attaches the placer
            return
        self._nodes.append(node)
        self._outstanding[id(node)] = 0
        if self.placer is not None:
            self.placer.attach(node)
        if self.distributor is not None:
            # static pool has no routing-popularity feed: stream the
            # whole catalog to the joiner over the existing warm nodes
            peers = [n for n in self._nodes if n is not node and n.alive]
            self.distributor.on_node_join(node, peers=peers)

    def remove_node(self, node: WorkerNode):
        """Graceful drain: stop routing; node finishes in-flight work."""
        if self.control_plane is not None:
            self.control_plane.drain(node)
            return
        node.alive = False

    def fail_node_at(self, t: float, idx: int):
        def do():
            node = self.nodes[idx]
            node.fail()
            if self.placer is not None:
                self.placer.on_node_failure(node)
            if self.control_plane is not None:
                self.control_plane.on_node_failure(node)

        self.loop.at(t, do)

    def run(self, until: Optional[float] = None):
        self.loop.run(until=until)

    @property
    def committed_avg_bytes(self) -> float:
        if self.control_plane is not None:
            return self.control_plane.committed_avg_bytes()
        return sum(n.committed_avg_bytes for n in self.nodes)


# ===========================================================================
# Keep-warm baseline (Firecracker / Knative)
# ===========================================================================
@dataclass
class Sandbox:
    fn_name: str
    committed_bytes: int
    idle_since: float = 0.0
    busy: bool = False


@dataclass
class _FnState:
    profile: ColdStartProfile          # boot(setup) + execute times
    context_bytes: int
    pool: List[Sandbox] = field(default_factory=list)
    waiting: int = 0
    # autoscaler state
    concurrency: int = 0
    history: List[Tuple[float, int]] = field(default_factory=list)


class KeepWarmPlatform:
    """Single-function baseline with a per-function warm sandbox pool."""

    def __init__(
        self,
        loop: EventLoop,
        *,
        cores: int = 16,
        guest_os_bytes: int = 128 << 20,
        hot_ratio: Optional[float] = None,  # forced ratio; None -> autoscale
        keepalive_s: float = 60.0,
        target_concurrency: float = 1.0,
        reap_interval_s: float = 1.0,
        seed: int = 0,
        name: str = "keepwarm",
    ):
        self.loop = loop
        self.cores = cores
        self.guest_os_bytes = guest_os_bytes
        self.hot_ratio = hot_ratio
        self.keepalive_s = keepalive_s
        self.target_concurrency = target_concurrency
        self.reap_interval_s = reap_interval_s
        self.rng = np.random.default_rng(seed)
        self.name = name
        self.fns: Dict[str, _FnState] = {}
        self.tracker = MemoryTracker(loop)
        self.latency = LatencyStats()
        self.cold_count = 0
        self.warm_count = 0
        self._core_free = cores
        self._runq: List[Tuple[float, Callable[[], None]]] = []
        self._reaper_started = False

    # ------------------------------------------------------------------
    def register(self, fn_name: str, profile: ColdStartProfile,
                 context_bytes: int = 1 << 20):
        self.fns[fn_name] = _FnState(profile=profile, context_bytes=context_bytes)

    def _sandbox_bytes(self, st: _FnState) -> int:
        return st.context_bytes + self.guest_os_bytes

    # ------------------------------------------------------- core model
    def _run_on_core(self, duration: float, done: Callable[[], None]):
        if self._core_free > 0:
            self._core_free -= 1

            def fin():
                self._core_free += 1
                done()
                if self._runq:
                    d, cb = self._runq.pop(0)
                    self._run_on_core(d, cb)

            self.loop.after(duration, fin)
        else:
            self._runq.append((duration, done))

    # ------------------------------------------------------------------
    def request_at(self, t: float, fn_name: str,
                   on_done: Optional[Callable[[float], None]] = None):
        self.loop.at(t, lambda: self._request(fn_name, on_done))

    def request_stream(self, arrivals,
                       on_done: Optional[Callable[[float], None]] = None):
        """Bulk trace injection: time-sorted ``(t, fn_name)`` pairs
        replayed through one heap cursor (see EventLoop.at_stream)."""
        self.loop.at_stream(arrivals, lambda fn_name: self._request(fn_name, on_done))

    def _request(self, fn_name: str, on_done):
        if not self._reaper_started and self.hot_ratio is None:
            self._reaper_started = True
            self.loop.after(self.reap_interval_s, self._reap, daemon=True)
        st = self.fns[fn_name]
        st.concurrency += 1
        t0 = self.loop.now
        idle = next((s for s in st.pool if not s.busy), None)

        forced_cold = (
            self.hot_ratio is not None
            and self.rng.random() >= self.hot_ratio
        )
        if idle is not None and not forced_cold:
            self.warm_count += 1
            self._serve(st, idle, t0, on_done, boot_s=0.0)
        else:
            self.cold_count += 1
            sb = Sandbox(fn_name, self._sandbox_bytes(st))
            st.pool.append(sb)
            self.tracker.commit(sb.committed_bytes)
            boot_s, _ = st.profile.sample(self.rng)
            self._serve(st, sb, t0, on_done, boot_s=boot_s)

    def _serve(self, st: _FnState, sb: Sandbox, t0: float, on_done,
               boot_s: float):
        sb.busy = True
        _, exec_s = st.profile.sample(self.rng)

        def finish():
            sb.busy = False
            sb.idle_since = self.loop.now
            st.concurrency -= 1
            lat = self.loop.now - t0
            self.latency.add(lat)
            if on_done:
                on_done(lat)

        self._run_on_core(boot_s + exec_s, finish)

    # -------------------------------------------------------- autoscaler
    def _reap(self):
        now = self.loop.now
        for st in self.fns.values():
            # Knative-style: desired = ceil(avg concurrency / target);
            # keep-alive grace before reaping idle sandboxes beyond desired
            st.history.append((now, st.concurrency))
            st.history = [(t, c) for t, c in st.history if now - t <= 60.0]
            avg_c = np.mean([c for _, c in st.history]) if st.history else 0.0
            desired = int(np.ceil(avg_c / self.target_concurrency))
            idle = [s for s in st.pool if not s.busy]
            idle.sort(key=lambda s: s.idle_since)
            keep = max(desired - sum(1 for s in st.pool if s.busy), 0)
            for sb in idle[keep:] if len(idle) > keep else []:
                if now - sb.idle_since > self.keepalive_s:
                    st.pool.remove(sb)
                    self.tracker.release(sb.committed_bytes)
        self.loop.after(self.reap_interval_s, self._reap, daemon=True)

    @property
    def committed_avg_bytes(self) -> float:
        return self.tracker.timeline.average(self.loop.now)
