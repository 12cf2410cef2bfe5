"""Dirigent-style elastic control plane: locality routing + node autoscaling.

The paper's cluster layer (SS5 "Dirigent") is what makes per-request
contexts pay off at fleet scale: committed memory tracks the active floor
only if the node pool itself follows load. This module replaces the static
``ClusterManager`` routing path with:

  * **two-level routing** - code-cache/locality affinity first (FaaSNet's
    observation: provisioning speed hinges on where function code already
    lives), falling back to load-aware spillover via power-of-two-choices
    on per-node outstanding work;
  * **node autoscaling** - scale up on per-node outstanding-load or
    queue-delay thresholds, paying a ``ColdStartProfile``-modeled node
    boot cost before the new node takes traffic (Boxer's ephemeral burst
    capacity); scale down after an idle keep-alive window, draining
    in-flight work before retiring a node;
  * **accounting** - per-node cache-hit / routed / committed-memory
    counters (``tracing.RoutingStats``), a node-count timeline, and
    cluster-wide committed-memory integration including the per-node
    runtime/OS base footprint that a static peak-provisioned fleet pays
    around the clock.

With cross-node compositions enabled (``cluster.CrossNodePlacer``), the
control plane additionally makes **vertex-granular** decisions:
``place_vertex`` applies the same two-level affinity/p2c policy to a
single compute function when the dispatcher exports a ready vertex, so
different vertices of one DAG can run on different nodes (the paper's
per-vertex elasticity claim). Placement decisions are journaled like
routing decisions (``place <fn> <node> ...`` entries).

Contract / determinism invariants:

  * everything runs on the shared deterministic ``EventLoop``; given the
    same seed and workload, routing decisions, scaling events, placements
    and final stats are bit-identical across runs — the decision journal
    (``journal=True``) is byte-stable (pinned by
    tests/test_control_plane.py);
  * the p2c RNG is consumed only on spillover (and never with a single
    active node), so enabling features that don't spill leaves the
    decision stream unchanged;
  * committed-memory aggregates are exact: every node tracker mirrors
    into ``cluster_mem`` streaming (no post-hoc timeline merging).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.coldstart import ColdStartProfile
from repro_torch.core.context import MemoryTracker
from repro_torch.core.dag import COMPUTE, SUBGRAPH, Composition
from repro_torch.core.node import WorkerNode
from repro_torch.core.sim import EventLoop, Timeline
from repro_torch.core.tracing import RoutingStats

BOOTING, ACTIVE, DRAINING, RETIRED = "booting", "active", "draining", "retired"


def composition_functions(comp: Composition) -> Tuple[str, ...]:
    """All compute-function names a composition (incl. nested subgraphs)
    will load - the set the affinity router matches against node caches."""
    cached = comp.__dict__.get("_compute_fns")
    if cached is not None:
        return cached
    names: List[str] = []

    def walk(c: Composition):
        for v in c.vertices.values():
            if v.kind == SUBGRAPH and v.subgraph is not None:
                walk(v.subgraph)
            elif v.kind == COMPUTE:
                names.append(v.function)

    walk(comp)
    out = tuple(dict.fromkeys(names))
    comp.__dict__["_compute_fns"] = out
    return out


def composition_batch_units(comp: Composition, registry) -> int:
    """Units of BATCH-engine work one invocation of ``comp`` submits:
    the sum of ``vertex.batch_units`` over batchable compute vertices
    (nested subgraphs included). Zero means the composition never
    touches a batching engine and batch-aware routing defers to the
    default policy. Cached on the composition — batchable flags and
    units are structural, identical across the registries a benchmark
    replays one composition against."""
    cached = comp.__dict__.get("_batch_units")
    if cached is not None:
        return cached
    total = 0

    def walk(c: Composition):
        nonlocal total
        for v in c.vertices.values():
            if v.kind == SUBGRAPH and v.subgraph is not None:
                walk(v.subgraph)
            elif v.kind == COMPUTE:
                cf = registry.functions.get(v.function)
                if cf is not None and getattr(cf, "batchable", False):
                    total += max(1, getattr(v, "batch_units", 1))

    walk(comp)
    comp.__dict__["_batch_units"] = total
    return total


@dataclass
class ReplicaConfig:
    """Knobs for BATCH-replica autoscaling (``ReplicaAutoscaler``):
    model-instance elasticity *within* nodes, one layer below the
    control plane's node autoscaling."""

    min_replicas: int = 0            # pool-wide floor of active replicas
    max_per_node: int = 2            # accelerator slots one node can host
    # scale-up triggers (either): queued units per active replica, or the
    # next coalesced steps already near-full (headroom exhausted)
    target_queue_per_replica: float = 8.0
    headroom_fraction: float = 0.9
    keepalive_s: float = 3.0         # idle window before a replica drains
    tick_interval_s: float = 0.25
    boot_s: float = 0.05             # replica spin-up (runtime attach; the
                                     # *weight* cold term stays on the
                                     # existing cold_setup_s task path)


class ReplicaAutoscaler:
    """Scales BATCH-engine replicas (model instances) inside a node pool.

    Each tick (a daemon event on the shared loop) it reads every node's
    batch backlog in *units* plus in-flight step occupancy and:

      * **scales up** when a node has queued work and either no active
        replica, a backlog above ``target_queue_per_replica``, or its
        next coalesced steps past ``headroom_fraction`` of capacity —
        paying ``boot_s`` before the new slot serves (weight residency
        stays task-driven: the first task on a cold node still charges
        ``cold_setup_s`` through the ``WeightStore`` miss path);
      * **scales down** a node whose batch engine sat fully idle past
        ``keepalive_s``, via ``EngineSet.retire_batch_slot`` — drain
        before retire, never below ``min_replicas`` pool-wide.

    Decisions are pure functions of observed queue state — no RNG — so
    scaling timelines are byte-stable run to run. Scale-up latencies
    (decision to slot-active) are recorded for the fig13 CI gate.
    """

    def __init__(
        self,
        loop: EventLoop,
        nodes,                       # list or callable -> live WorkerNodes
        *,
        config: Optional[ReplicaConfig] = None,
        journal: bool = False,
    ):
        self.loop = loop
        self._nodes = nodes if callable(nodes) else (lambda: list(nodes))
        self.cfg = config or ReplicaConfig()
        self.journal: Optional[List[str]] = [] if journal else None
        self.scale_ups = 0
        self.scale_downs = 0
        self.scaleup_latencies: List[float] = []
        self._pending: Dict[int, int] = {}     # node id -> booting replicas
        self._idle_since: Dict[int, float] = {}
        self._ticking = False

    def _log(self, msg: str):
        if self.journal is not None:
            self.journal.append(f"{self.loop.now:.9f} {msg}")

    @staticmethod
    def _is_batch(node: WorkerNode) -> bool:
        eng = node.engines
        return eng.batch_model is not None or bool(eng.batch_models)

    def start(self):
        if self._ticking:
            return
        self._ticking = True
        if self.cfg.min_replicas > 0:
            self._ensure_floor()
        self._attach_starvation_hooks()
        self.loop.after(self.cfg.tick_interval_s, self._tick, daemon=True)

    def _attach_starvation_hooks(self):
        """Wire every batch node's ``on_batch_starved`` liveness hook to
        an immediate scale-up. The tick is a *daemon* event: a decode
        task queued on a zero-replica node with nothing else scheduled
        would otherwise strand when the loop drains — the hook's boot
        event is non-daemon, so it keeps the loop alive."""
        for n in self._nodes():
            if self._is_batch(n) and n.engines.on_batch_starved is None:
                n.engines.on_batch_starved = (lambda n=n: self._starved(n))

    def _starved(self, node: WorkerNode):
        """Synchronous kick from the engine: batchable work just queued
        (or the last replica just retired) with zero active replicas.
        Boot one now — the decision the next tick would take anyway
        (``eff == 0`` is unconditionally pressured), so timing moves
        from tick-aligned to enqueue-aligned and stays deterministic."""
        cfg = self.cfg
        nid = id(node)
        pending = self._pending.get(nid, 0)
        if (not node.alive
                or node.engines.active_batch_slots() + pending > 0
                or pending >= cfg.max_per_node):
            return
        self.scale_ups += 1
        self._pending[nid] = pending + 1
        t0 = self.loop.now
        self._log(f"replica_up {node.name} starved")

        def activate(n=node, nid=nid, t0=t0):
            self._pending[nid] -= 1
            if not n.alive:
                return
            n.engines.add_batch_slot()
            self.scaleup_latencies.append(self.loop.now - t0)
            self._log(f"replica_ready {n.name} "
                      f"lat={self.loop.now - t0:.6f}")

        self.loop.after(cfg.boot_s, activate)

    def prewarm(self):
        """Predictive spin-up (``BurstPredictor``): boot one replica on
        every batch-capable node currently at zero replicas, through the
        normal ``_starved`` activate path — same ``boot_s``, same
        accounting, just enqueue-aligned to the *predicted* burst rather
        than the first starved task."""
        for n in self._nodes():
            if n.alive and self._is_batch(n):
                self._starved(n)

    def _ensure_floor(self):
        """Provision the ``min_replicas`` floor round-robin (instant,
        like the control plane's min_nodes: the floor exists before
        traffic does)."""
        nodes = [n for n in self._nodes() if self._is_batch(n)]
        if not nodes:
            return
        total = sum(n.engines.active_batch_slots() for n in nodes)
        attempts = 0
        i = 0
        while total < self.cfg.min_replicas and attempts <= len(nodes):
            n = nodes[i % len(nodes)]
            if n.engines.active_batch_slots() < self.cfg.max_per_node:
                n.engines.add_batch_slot()
                total += 1
                attempts = 0
            else:
                attempts += 1
            i += 1

    def _tick(self):
        cfg = self.cfg
        now = self.loop.now
        nodes = [n for n in self._nodes() if n.alive and self._is_batch(n)]
        for n in nodes:                    # nodes booted since last tick
            if n.engines.on_batch_starved is None:
                n.engines.on_batch_starved = (lambda n=n: self._starved(n))
        total_active = sum(
            n.engines.active_batch_slots() + self._pending.get(id(n), 0)
            for n in nodes
        )
        for n in nodes:
            eng = n.engines
            nid = id(n)
            pending = self._pending.get(nid, 0)
            eff = eng.active_batch_slots() + pending
            backlog = eng.batch_queued_units()
            inflight = eng.batch_inflight_units
            # ---- scale up on queue pressure / coalesced-step headroom
            if backlog > 0 and eff < cfg.max_per_node:
                cap = eff * eng.max_batch
                pressured = (
                    eff == 0
                    or backlog > cfg.target_queue_per_replica * eff
                    or backlog + inflight >= cfg.headroom_fraction * cap
                )
                if pressured:
                    self.scale_ups += 1
                    self._pending[nid] = pending + 1
                    self._log(f"replica_up {n.name} backlog={backlog} "
                              f"active={eff}")

                    def activate(n=n, nid=nid, t0=now):
                        self._pending[nid] -= 1
                        if not n.alive:
                            return
                        n.engines.add_batch_slot()
                        self.scaleup_latencies.append(self.loop.now - t0)
                        self._log(f"replica_ready {n.name} "
                                  f"lat={self.loop.now - t0:.6f}")

                    self.loop.after(cfg.boot_s, activate)
                    total_active += 1
                    eff += 1
            # ---- idle clock / scale down (one replica per node per tick)
            if backlog > 0 or inflight > 0 or eng.active_batch_slots() == 0:
                self._idle_since.pop(nid, None)
            else:
                since = self._idle_since.setdefault(nid, now)
                if (now - since >= cfg.keepalive_s
                        and total_active - 1 >= cfg.min_replicas
                        and eng.retire_batch_slot()):
                    self.scale_downs += 1
                    total_active -= 1
                    self._log(f"replica_down {n.name}")
                    if eng.active_batch_slots() == 0:
                        self._idle_since.pop(nid, None)
        self.loop.after(cfg.tick_interval_s, self._tick, daemon=True)

    def summary(self) -> Dict[str, float]:
        lats = self.scaleup_latencies
        return {
            "replica_scale_ups": self.scale_ups,
            "replica_scale_downs": self.scale_downs,
            "scaleup_latency_max_s": max(lats) if lats else 0.0,
            "scaleup_latency_avg_s": sum(lats) / len(lats) if lats else 0.0,
        }


@dataclass
class PredictorConfig:
    """Knobs for trace-driven burst prediction (``BurstPredictor``).
    Ships only through ``sdk.PlatformConfig(predictor=...)``."""

    bin_s: float = 0.5          # arrival-count bin width
    alpha: float = 0.2          # EWMA smoothing over per-bin counts
    on_factor: float = 1.5      # bin > on_factor * EWMA after quiet => ON edge
    min_cycles: int = 2         # ON-edge gaps observed before predicting
    lead_s: float = 1.0         # fire this early before the predicted edge
    nodes_ahead: int = 1        # nodes pre-booted per predicted burst
    prewarm_replicas: bool = True  # also spin BATCH replicas via autoscaler
    max_history: int = 64       # ON-edge timestamps retained

    def __post_init__(self):
        if self.bin_s <= 0.0:
            raise ValueError(f"predictor bin_s must be > 0, got {self.bin_s}")
        if not 0.0 < self.alpha <= 1.0:
            raise ValueError(f"predictor alpha must be in (0, 1], "
                             f"got {self.alpha}")
        if self.min_cycles < 1:
            raise ValueError(f"predictor min_cycles must be >= 1, "
                             f"got {self.min_cycles}")


class BurstPredictor:
    """EWMA + ON/OFF period detection over the arrival stream.

    ``observe(t)`` is called synchronously from ``route`` — the predictor
    costs *zero* loop events until it has learned a period, so a disabled
    or still-learning predictor leaves the event stream untouched.
    Arrivals are counted into ``bin_s`` bins; a bin whose count jumps
    past ``on_factor`` times the EWMA after a silent bin is an ON edge
    (fig11/fig13's duty-cycled traces go fully quiet between bursts).
    Once ``min_cycles`` edge-to-edge gaps are seen, the period estimate
    (median gap — robust to one irregular cycle) schedules ``on_burst``
    at the next predicted edge minus ``lead_s``: early enough that node
    boot delay leaves the p99 entirely (Boxer's argument). Prediction
    events are daemon events — an armed prediction past the end of the
    trace never keeps the loop alive. No RNG; byte-deterministic."""

    def __init__(self, loop: EventLoop, config: Optional[PredictorConfig]
                 = None, *, on_burst: Optional[Callable[[float], None]] = None):
        self.loop = loop
        self.cfg = config or PredictorConfig()
        self.on_burst = on_burst
        self.edges: List[float] = []        # detected ON-edge times
        self.predictions: List[float] = []  # scheduled fire times
        self.fired = 0
        self._bin_i: Optional[int] = None
        self._count = 0
        self._ewma = 0.0
        self._on = False
        self._last_fire_t = -float("inf")

    @property
    def period_s(self) -> Optional[float]:
        """Current period estimate (median ON-edge gap), or None while
        still learning."""
        gaps = [b - a for a, b in zip(self.edges, self.edges[1:])]
        if len(gaps) < self.cfg.min_cycles:
            return None
        return sorted(gaps)[len(gaps) // 2]

    def observe(self, t: float) -> None:
        """Count one arrival at virtual time ``t`` (monotone non-dec)."""
        i = int(t / self.cfg.bin_s)
        if self._bin_i is None:
            self._bin_i = i
        while i > self._bin_i:
            self._close_bin()
            self._bin_i += 1
        self._count += 1

    def _close_bin(self) -> None:
        c = self._count
        self._count = 0
        if c == 0:
            self._on = False                 # silent bin: OFF
        elif not self._on and self._ewma > 0.0 \
                and c > self.cfg.on_factor * self._ewma:
            self._on = True
            self._edge(self._bin_i * self.cfg.bin_s)
        a = self.cfg.alpha
        self._ewma = c if self._ewma == 0.0 else (1 - a) * self._ewma + a * c

    def _edge(self, t: float) -> None:
        self.edges.append(t)
        if len(self.edges) > self.cfg.max_history:
            self.edges.pop(0)
        period = self.period_s
        if period is None or period <= 0.0:
            return
        fire_t = t + period - self.cfg.lead_s
        # one armed prediction per cycle; never fire in the past
        if fire_t <= self.loop.now or fire_t <= self._last_fire_t:
            return
        self._last_fire_t = fire_t
        self.predictions.append(fire_t)
        self.loop.at(fire_t, lambda ft=fire_t: self._fire(ft), daemon=True)

    def _fire(self, predicted_t: float) -> None:
        self.fired += 1
        if self.on_burst is not None:
            self.on_burst(predicted_t)

    def summary(self) -> Dict[str, float]:
        return {
            "edges": len(self.edges),
            "predictions": len(self.predictions),
            "fired": self.fired,
            "period_s": self.period_s or 0.0,
        }


class BatchRouter:
    """Marginal-latency estimator behind the ``batch_aware`` routing
    policy: score each candidate node by when its *next coalesced step*
    could absorb this composition's batchable units, instead of by
    shortest invocation queue.

    ``estimate`` prices a node as (queued + in-flight units) divided by
    active-replica step capacity, times the replica's full-batch
    ``BatchStepModel.step_s`` — plus a ``spinup_s`` penalty when no
    replica is active and a ``cold_s`` penalty when the node's
    ``WeightStore`` holds none of the composition's models resident.
    Ties break on invocation load then stable node order, so with one
    replica/one model (every estimate equal) the decision sequence is
    exactly the least-outstanding policy's — the degeneration contract
    pinned by tests/test_fleet_serving.py. No RNG is consumed."""

    def __init__(self, *, spinup_s: float = 0.3, cold_s: float = 0.0):
        self.spinup_s = spinup_s
        self.cold_s = cold_s
        self.decisions = 0

    def estimate(self, node: WorkerNode, units: int, fns=()) -> float:
        eng = node.engines
        model = eng.batch_model
        if model is None and eng.batch_models:
            model = next(iter(eng.batch_models.values()))
        if model is None:
            return float("inf")
        mb = max(eng.max_batch, 1)
        units = min(max(units, 1), mb)
        active = eng.active_batch_slots()
        if active == 0:
            est = self.spinup_s + model.step_s(units)
        else:
            backlog = eng.batch_queued_units() + eng.batch_inflight_units
            est = (backlog / (active * mb)) * model.step_s(mb) \
                + model.step_s(units)
        if self.cold_s > 0.0:
            ws = node.weight_store
            if ws is not None and not ws.pinned:
                for fn in fns:
                    if not ws.fn_resident(fn):
                        est += self.cold_s
                        break
        return est

    def pick(self, nodes: List[WorkerNode], comp: Composition, registry,
             load: Callable[[WorkerNode], float]):
        """Best node for ``comp`` by marginal estimate, or None when the
        composition has no batchable work (caller falls back to its
        default policy)."""
        units = composition_batch_units(comp, registry)
        if units == 0 or not nodes:
            return None
        fns = composition_functions(comp)
        best = None
        best_key = None
        for i, n in enumerate(nodes):
            key = (self.estimate(n, units, fns), load(n), i)
            if best_key is None or key < best_key:
                best, best_key = n, key
        self.decisions += 1
        return best


@dataclass
class ControlPlaneConfig:
    min_nodes: int = 1
    max_nodes: int = 8
    # ---- scale-up triggers (either one fires)
    target_outstanding_per_node: float = 8.0
    max_queue_delay_s: float = 25e-3
    # ---- scale-down: fully-idle nodes past keep-alive are drained, and a
    # sustained-low-utilization cluster sheds its least-loaded node once the
    # survivors can absorb the work below this fraction of target load
    keepalive_s: float = 30.0
    scale_down_watermark: float = 0.8
    tick_interval_s: float = 0.5
    # ---- routing: an affinity node this overloaded spills to p2c anyway
    affinity_overload_factor: float = 2.0
    # ---- node provisioning cost (VM boot / runtime start), sampled per boot
    node_boot: ColdStartProfile = field(
        default_factory=lambda: ColdStartProfile(
            setup_s=1.0, execute_s=0.0, jitter_sigma=0.1
        )
    )
    # runtime/OS footprint committed while a node is up (used when the
    # factory does not set WorkerNode.base_bytes)
    node_base_bytes: int = 256 << 20
    # ---- serving-tier elasticity: BATCH-replica autoscaling inside the
    # pool, and marginal-latency routing over those replicas
    replicas: Optional[ReplicaConfig] = None
    route_policy: str = "affinity"   # "affinity" | "batch_aware"
    batch_router: Optional[BatchRouter] = None  # default-built when
                                                # route_policy=batch_aware


@dataclass
class ManagedNode:
    node: WorkerNode
    state: str = BOOTING
    outstanding: int = 0
    idle_since: float = 0.0
    boot_t: float = 0.0
    ready_t: float = 0.0
    base_committed: int = 0


class ElasticControlPlane:
    """Owns the node pool: routes invocations, scales nodes with load."""

    def __init__(
        self,
        loop: EventLoop,
        node_factory: Callable[[str], WorkerNode],
        *,
        config: Optional[ControlPlaneConfig] = None,
        seed: int = 0,
        journal: bool = False,
        predictor: Optional[PredictorConfig] = None,
        distributor=None,   # artifacts.P2PDistributor (optional)
    ):
        self.loop = loop
        self.factory = node_factory
        self.cfg = config or ControlPlaneConfig()
        if self.cfg.min_nodes < 1:
            raise ValueError("control plane needs min_nodes >= 1")
        self.rng = np.random.default_rng(seed)
        self.stats = RoutingStats()
        # cluster-wide committed-memory aggregate: every node tracker and
        # the base-bytes tracker mirror into it, so cluster average/peak
        # are O(1) streaming reads instead of per-query timeline merges
        self.cluster_mem = MemoryTracker(loop)
        self.mem = MemoryTracker(loop, parent=self.cluster_mem)  # node base bytes
        self.node_count_timeline = Timeline()
        self.members: List[ManagedNode] = []
        self._by_node: Dict[int, ManagedNode] = {}
        self._ids = itertools.count()
        self._ticking = False
        self._low_since: Optional[float] = None
        self.journal: Optional[List[str]] = [] if journal else None
        # cross-node vertex placement (cluster.CrossNodePlacer); set by the
        # ClusterManager when CROSSNODE is enabled — every node this plane
        # boots or adopts is attached so its dispatcher exports ready
        # vertices back to the cluster layer
        self.placer = None
        if self.cfg.route_policy not in ("affinity", "batch_aware"):
            raise ValueError(
                f"unknown route_policy {self.cfg.route_policy!r}")
        self.batch_router: Optional[BatchRouter] = (
            self.cfg.batch_router
            or (BatchRouter() if self.cfg.route_policy == "batch_aware"
                else None)
        )
        # P2P artifact prefetch on node join (core.artifacts); None (the
        # default) leaves every existing code path untouched
        self.distributor = distributor
        # trace-driven burst prediction: observe() is a synchronous call
        # from route(), so a disabled predictor adds zero loop events
        self.predictor: Optional[BurstPredictor] = None
        if predictor is not None:
            self.predictor = BurstPredictor(
                self.loop, predictor, on_burst=self._on_burst_predicted
            )
        for _ in range(self.cfg.min_nodes):
            self._boot_node(instant=True)
        self.replica_autoscaler: Optional[ReplicaAutoscaler] = None
        if self.cfg.replicas is not None:
            self.replica_autoscaler = ReplicaAutoscaler(
                loop,
                lambda: [m.node for m in self.members
                         if m.state == ACTIVE and m.node.alive],
                config=self.cfg.replicas,
                journal=journal,
            )
            self.replica_autoscaler.start()

    # ------------------------------------------------------------- pool
    @property
    def worker_nodes(self) -> List[WorkerNode]:
        """Nodes currently up (taking or finishing traffic)."""
        return [m.node for m in self.members if m.state in (ACTIVE, DRAINING)]

    @property
    def active_count(self) -> int:
        return sum(1 for m in self.members if m.state == ACTIVE)

    @property
    def active_nodes(self) -> List[WorkerNode]:
        """Alive ACTIVE nodes — the set new work may land on (draining
        nodes finish what they have but take nothing new)."""
        return [m.node for m in self.members
                if m.state == ACTIVE and m.node.alive]

    def _log(self, msg: str):
        if self.journal is not None:
            self.journal.append(f"{self.loop.now:.9f} {msg}")

    def _record_count(self):
        up = sum(1 for m in self.members if m.state in (ACTIVE, DRAINING))
        self.node_count_timeline.record(self.loop.now, float(up))

    def _boot_node(self, instant: bool = False):
        name = f"en{next(self._ids)}"
        node = self.factory(name)
        # a node may schedule on its own shard of the shared loop
        # (ShardedEventLoop), but never on an unrelated loop: clocks
        # would silently diverge
        if node.loop is not self.loop and \
                getattr(node.loop, "_owner", None) is not self.loop:
            raise ValueError(f"{name}: factory must build nodes on the shared loop")
        node.tracker.attach_parent(self.cluster_mem)
        if self.placer is not None:
            self.placer.attach(node)
        m = ManagedNode(node=node, boot_t=self.loop.now)
        self.members.append(m)
        self._by_node[id(node)] = m
        if instant:
            self._node_ready(m)
        else:
            boot_s, _ = self.cfg.node_boot.sample(self.rng)
            self.stats.scale_ups += 1
            self._log(f"scale_up {name} boot_s={boot_s:.6f}")
            self.loop.after(boot_s, lambda: self._node_ready(m))

    def _node_ready(self, m: ManagedNode):
        if not m.node.alive:            # failed while booting
            m.state = RETIRED
            return
        m.state = ACTIVE
        m.ready_t = self.loop.now
        m.idle_since = self.loop.now
        m.base_committed = m.node.base_bytes or self.cfg.node_base_bytes
        self.mem.commit(m.base_committed)
        self._log(f"ready {m.node.name}")
        self._record_count()
        if self.distributor is not None:
            # stream the hot artifact set to the fresh node over warm
            # peers; nothing is hot before any traffic (initial
            # min_nodes boots), so seed nodes warm through requests
            hot = self.distributor.cfg.hot_k
            hot_fns = self.stats.hot_functions(hot)
            if hot_fns:
                peers = [p.node for p in self.members
                         if p is not m and p.state in (ACTIVE, DRAINING)
                         and p.node.alive]
                self.distributor.on_node_join(
                    m.node, peers=peers, hot_fns=hot_fns
                )

    def adopt(self, node: WorkerNode):
        """Register an externally created node as active (manual add)."""
        node.tracker.attach_parent(self.cluster_mem)
        if self.placer is not None:
            self.placer.attach(node)
        m = ManagedNode(node=node, boot_t=self.loop.now)
        self.members.append(m)
        self._by_node[id(node)] = m
        self._node_ready(m)

    # ---------------------------------------------------------- routing
    def _pick_two_level(
        self,
        active: List[ManagedNode],
        fns,
        load: Callable[[ManagedNode], float],
        prefer: Optional[WorkerNode] = None,
    ) -> Tuple[ManagedNode, str]:
        """The shared two-level scorer behind ``route`` (whole
        compositions, load = outstanding) and ``place_vertex`` (single
        vertices, load includes placed-vertex counts, ties prefer the
        home node). Affinity: best code-cache residency wins among nodes
        under the overload limit; ties bin-pack — fill a node up to its
        slot count before spilling, so lightly loaded nodes go fully
        idle and the autoscaler can reap them (spreading a trickle over
        every warm node keeps the whole fleet alive forever). Fallback:
        power-of-two-choices on load (no RNG draw with one candidate)."""
        affinity: List[Tuple[float, ManagedNode]] = []
        for m in active:
            limit = self.cfg.affinity_overload_factor * max(m.node.num_slots, 1)
            score = m.node.warm_fraction(fns)
            if score > 0.0 and load(m) < limit:
                affinity.append((score, m))
        if affinity:
            def pack_key(sm):
                score, m = sm
                slots = max(m.node.num_slots, 1)
                under = load(m) < slots
                depth = load(m) if under else -load(m)
                return (score, under, depth, m.node is prefer)

            return max(affinity, key=pack_key)[1], "affinity"
        if len(active) == 1:
            return active[0], "spillover"
        i, j = self.rng.choice(len(active), size=2, replace=False)
        a, b = active[int(i)], active[int(j)]
        return (a if load(a) <= load(b) else b), "spillover"

    def route(self, comp: Composition) -> WorkerNode:
        """Two-level policy: code-cache affinity, else p2c on load."""
        self._ensure_tick()
        if self.predictor is not None:
            self.predictor.observe(self.loop.now)
        # per-function popularity feeds the distributor's hot set; pure
        # counter accounting, recorded only when someone consumes it
        track = composition_functions(comp) if self.distributor is not None \
            else ()
        active = [m for m in self.members if m.state == ACTIVE and m.node.alive]
        if not active:
            raise RuntimeError("no active nodes")
        if self.batch_router is not None:
            by_node = {id(m.node): m for m in active}
            picked = self.batch_router.pick(
                [m.node for m in active], comp, active[0].node.registry,
                load=lambda n: by_node[id(n)].outstanding,
            )
            if picked is not None:
                m = by_node[id(picked)]
                self.stats.record_route(m.node.name, affinity=False,
                                        fns=track)
                self._log(f"route {m.node.name} batch out={m.outstanding}")
                return m.node
        fns = composition_functions(comp)
        pick, kind = self._pick_two_level(active, fns, lambda m: m.outstanding)
        self.stats.record_route(pick.node.name, affinity=(kind == "affinity"),
                                fns=track)
        self._log(f"route {pick.node.name} {kind} out={pick.outstanding}")
        return pick.node

    def place_vertex(
        self,
        fn_name: str,
        home: WorkerNode,
        vload: Callable[[WorkerNode], int],
    ) -> WorkerNode:
        """Vertex-granular routing decision (cross-node compositions): the
        same two-level code-cache-affinity / p2c policy as ``route``,
        scored on the single compute function the ready vertex runs.
        ``vload(node)`` is the placer's count of vertices in flight on a
        node — layered on invocation-level ``outstanding`` so placements
        spread even within one composition. Ties prefer the home node (no
        transfer charge). With a single active node no RNG is consumed
        and the home path is taken (byte-identity with CROSSNODE=0 on
        1-node clusters)."""
        active = [m for m in self.members if m.state == ACTIVE and m.node.alive]
        if not active:
            return home
        if len(active) == 1:
            return active[0].node

        def load(m: ManagedNode) -> int:
            return m.outstanding + vload(m.node)

        pick, kind = self._pick_two_level(active, (fn_name,), load, prefer=home)
        self._log(f"place {fn_name} {pick.node.name} {kind} load={load(pick)}")
        return pick.node

    def on_dispatch(self, node: WorkerNode):
        m = self._by_node[id(node)]
        m.outstanding += 1

    def _foreign_load(self, m: ManagedNode) -> int:
        """Cross-node vertices placed on this node by other homes: work
        the invocation-level ``outstanding`` cannot see, but that must
        block drain/retire just the same."""
        return self.placer.vertex_load(m.node) if self.placer is not None else 0

    def on_complete(self, node: WorkerNode):
        m = self._by_node[id(node)]
        m.outstanding -= 1
        if m.outstanding <= 0:
            m.outstanding = 0
            if self._foreign_load(m) == 0:
                m.idle_since = self.loop.now
                if m.state == DRAINING:
                    self._retire(m, reason="drained")

    def on_vertex_complete(self, node: WorkerNode):
        """Placer notification: the last foreign-placed vertex on ``node``
        finished. Completes a deferred drain and restarts the idle clock
        (placed work must keep a node as alive as homed work)."""
        m = self._by_node.get(id(node))
        if m is None or m.outstanding > 0 or self._foreign_load(m) != 0:
            return
        m.idle_since = self.loop.now
        if m.state == DRAINING:
            self._retire(m, reason="drained")

    # ------------------------------------------------------- autoscaler
    def _ensure_tick(self):
        if not self._ticking:
            self._ticking = True
            self.loop.after(self.cfg.tick_interval_s, self._tick, daemon=True)

    def _tick(self):
        now = self.loop.now
        # reap nodes that died (ClusterManager re-executes their work)
        for m in self.members:
            if m.state in (ACTIVE, DRAINING) and not m.node.alive:
                self._retire(m, reason="failure")

        active = [m for m in self.members if m.state == ACTIVE]
        booting = [m for m in self.members if m.state == BOOTING]

        # ---- scale up: outstanding load or queue delay over threshold
        if active and len(active) + len(booting) < self.cfg.max_nodes:
            per_node = sum(m.outstanding for m in active) / len(active)
            qdelay = max(m.node.queue_delay_s() for m in active)
            if (
                per_node > self.cfg.target_outstanding_per_node
                or qdelay > self.cfg.max_queue_delay_s
            ):
                self._boot_node()

        # ---- scale down (one node per tick at most)
        if len(active) > self.cfg.min_nodes:
            # (a) a node fully idle past keep-alive retires outright
            # (foreign-placed cross-node vertices count as busy work)
            idle = [
                m for m in active
                if m.outstanding == 0 and self._foreign_load(m) == 0
                and now - m.idle_since > self.cfg.keepalive_s
            ]
            if idle:
                idle.sort(key=lambda m: m.idle_since)
                self.drain(idle[0].node)
            else:
                # (b) sustained low utilization: survivors could absorb all
                # work below the watermark -> drain the least-loaded node
                total = sum(m.outstanding for m in active)
                absorbable = (
                    total
                    <= (len(active) - 1)
                    * self.cfg.target_outstanding_per_node
                    * self.cfg.scale_down_watermark
                )
                if not absorbable:
                    self._low_since = None
                elif self._low_since is None:
                    self._low_since = now
                elif now - self._low_since > self.cfg.keepalive_s:
                    victim = min(active, key=lambda m: (
                        m.outstanding + self._foreign_load(m), m.node.name,
                    ))
                    self.drain(victim.node)
                    self._low_since = now
        else:
            self._low_since = None

        self.loop.after(self.cfg.tick_interval_s, self._tick, daemon=True)

    def _on_burst_predicted(self, predicted_t: float):
        """A learned ON edge is ``lead_s`` away: boot ``nodes_ahead``
        nodes now (normal boot path — same RNG-sampled delay, same
        journal/accounting) so they are ACTIVE when the burst lands,
        and optionally pre-spin BATCH replicas on existing nodes."""
        assert self.predictor is not None
        cfg = self.predictor.cfg
        active = sum(1 for m in self.members if m.state == ACTIVE)
        booting = sum(1 for m in self.members if m.state == BOOTING)
        n = min(cfg.nodes_ahead, self.cfg.max_nodes - active - booting)
        self._log(f"predict_burst t={predicted_t:.6f} boots={max(n, 0)}")
        for _ in range(max(n, 0)):
            self._boot_node()
        if cfg.prewarm_replicas and self.replica_autoscaler is not None:
            self.replica_autoscaler.prewarm()

    def on_node_failure(self, node: WorkerNode):
        """Out-of-band failure notification (the periodic tick would also
        reap the dead node, but may not run again if the loop drains)."""
        m = self._by_node.get(id(node))
        if m is not None and m.state in (ACTIVE, DRAINING, BOOTING):
            self._retire(m, reason="failure")

    def drain(self, node: WorkerNode):
        """Stop routing to ``node``; it finishes in-flight work, then
        retires (drain-before-remove)."""
        m = self._by_node[id(node)]
        if m.state != ACTIVE:
            return
        m.state = DRAINING
        self.stats.drains += 1
        self._log(f"drain {m.node.name} out={m.outstanding}")
        if m.outstanding == 0 and self._foreign_load(m) == 0:
            self._retire(m, reason="idle")

    def _retire(self, m: ManagedNode, reason: str):
        if m.state == RETIRED:
            return
        m.state = RETIRED
        m.node.alive = False
        if m.base_committed:
            self.mem.release(m.base_committed)
            m.base_committed = 0
        if reason != "failure":
            self.stats.scale_downs += 1
        self._log(f"retire {m.node.name} reason={reason}")
        self._record_count()

    # ------------------------------------------------------- accounting
    def committed_avg_bytes(self, t_end: Optional[float] = None) -> float:
        """Cluster committed-memory average over [start, t_end]: node base
        footprints plus every node's context memory. O(1): every member
        tracker mirrors into ``cluster_mem`` as events happen."""
        t_end = self.loop.now if t_end is None else t_end
        return self.cluster_mem.timeline.average(t_end)

    def committed_peak_bytes(self) -> float:
        """Exact peak of the merged committed-memory step function,
        maintained streaming by the aggregate tracker (equals
        ``merged_peak`` over the member timelines)."""
        return self.cluster_mem.timeline.peak()

    def summary(self, t_end: Optional[float] = None) -> Dict[str, float]:
        t_end = self.loop.now if t_end is None else t_end
        # refresh per-node counters from node-local caches/trackers
        for m in self.members:
            nc = self.stats.node(m.node.name)
            if m.node.code_cache is not None:
                nc.cache_hits = m.node.code_cache.hits
                nc.cache_misses = m.node.code_cache.misses
            pts = m.node.tracker.timeline.points
            if pts:
                nc.committed_avg_bytes = m.node.tracker.timeline.average(t_end)
        out = self.stats.summary()
        out.update({
            "nodes_avg": self.node_count_timeline.average(t_end),
            "nodes_peak": self.node_count_timeline.peak(),
            "committed_avg_mb": self.committed_avg_bytes(t_end) / 1024**2,
            "committed_peak_mb": self.committed_peak_bytes() / 1024**2,
        })
        return out
