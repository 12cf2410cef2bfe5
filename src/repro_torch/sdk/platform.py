"""The ``Platform`` facade: one front door for every execution shape.

Hand-wired code picks among three divergent entry-point triplets —
``WorkerNode.invoke/invoke_at/invoke_stream`` on a node,
``ClusterManager.invoke/invoke_at/invoke_stream`` on a pool — and wires
``FunctionRegistry``/``ServiceRegistry``/``EventLoop``/node factories by
hand per driver. A ``Platform`` owns all of that behind one object:

    platform = sdk.Platform(node=sdk.NodeSpec(num_slots=8))      # 1 node
    platform = sdk.Platform(pool=[sdk.NodeSpec(...), ...])       # static
    platform = sdk.Platform(elastic=sdk.Elastic(config=cfg))     # elastic

    platform.deploy(app)                 # register functions + graph
    h = platform.invoke(app, inputs)     # -> InvocationHandle (future)
    h.result()                           # run loop until done, or raise
    platform.submit_stream(arrivals)     # bulk trace injection
    platform.run(until=...)

``invoke``/``submit_stream`` behave identically across the three shapes
(same signature, same handle semantics); only the routing underneath
changes. Nodes are built lazily at first use, after deployments, so the
shared profiles dict every node's dispatcher reads is fully populated
when factories run.

Determinism contract: a Platform adds no scheduling, RNG draws, or
timing of its own — it forwards to exactly the node/cluster calls the
hand-wired drivers made, so migrated benchmarks reproduce their
committed CSV rows byte-for-byte (gated by tools/check_bench_identity.py).
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.cluster import ClusterManager
from repro_torch.core.coldstart import ColdStartProfile, TransferProfile
from repro_torch.core.control_plane import ControlPlaneConfig, ElasticControlPlane
from repro_torch.core.dag import Composition, RetryPolicy
from repro_torch.core.http import ServiceRegistry
from repro_torch.core.items import SetDict
from repro_torch.core.node import WorkerNode
from repro_torch.core.registry import FunctionRegistry
from repro_torch.core.sim import EventLoop, ShardedEventLoop
from repro_torch.sdk.builder import App
from repro_torch.sdk.config import PlatformConfig
from repro_torch.sdk.errors import DeploymentError, InvocationFailed, PurityError
from repro_torch.sdk.functions import FunctionSpec


def _safe_eq(a, b) -> bool:
    """Equality that tolerates values whose ``==`` is non-boolean
    (numpy arrays or torch tensors in lambda defaults and closures):
    identity first, then ``==`` coerced to bool, treating any comparison
    error as unequal. Tensors are equal only with the same shape, dtype
    and device (``==`` would broadcast, promote, or raise across
    devices); a CUDA tensor's ``.all()`` synchronises the card."""
    if a is b:
        return True
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.shape == b.shape and a.dtype == b.dtype
                and a.device == b.device and bool((a == b).all()))
    try:
        r = a == b
        if hasattr(r, "all"):   # elementwise (numpy) comparison
            return (getattr(a, "shape", None) == getattr(b, "shape", None)
                    and bool(r.all()))
        return bool(r)
    except Exception:
        return False


def _same_payload(a, b) -> bool:
    """Whether two payload callables are interchangeable for idempotent
    re-deployment: the same object, or functions from the same
    definition site with equal defaults and closure values (spec
    factories like ``log_processing_specs`` recreate equivalent lambdas
    per call)."""
    if a is b:
        return True
    ca, cb = getattr(a, "__code__", None), getattr(b, "__code__", None)
    if ca is None or cb is None or ca is not cb:
        return False
    da = getattr(a, "__defaults__", None) or ()
    db = getattr(b, "__defaults__", None) or ()
    if len(da) != len(db) or not all(map(_safe_eq, da, db)):
        return False
    fa, fb = a.__closure__, b.__closure__
    if (fa is None) != (fb is None):
        return False
    if fa is not None:
        try:
            va = [c.cell_contents for c in fa]
            vb = [c.cell_contents for c in fb]
        except ValueError:     # unset cell: treat as conflicting
            return False
        if len(va) != len(vb) or not all(map(_safe_eq, va, vb)):
            return False
    return True


def _default_loop() -> EventLoop:
    """The loop a Platform builds when none is passed in.

    ``DANDELION_SHARDS=1`` opts into the node-sharded loop
    (``core.sim.ShardedEventLoop``): every node built by this platform
    schedules on its own shard heap. The default mode is *exact* —
    byte-identical event order to the single merged heap — unless
    ``DANDELION_SHARD_LOOKAHEAD_S`` sets a conservative-window lookahead
    (sound only for topologies whose cross-node ``TRANSFER`` latencies
    are at least the lookahead; see the ShardedEventLoop docstring).
    Unset, the plain ``EventLoop`` remains the zero-risk default."""
    if os.environ.get("DANDELION_SHARDS") == "1":
        la = float(os.environ.get("DANDELION_SHARD_LOOKAHEAD_S", "0.0"))
        return ShardedEventLoop(lookahead_s=la)
    return EventLoop()


def _node_loop(loop, name: str):
    """The loop view a node named ``name`` should schedule on: its shard
    of a ``ShardedEventLoop``, or the shared loop itself otherwise."""
    shard = getattr(loop, "shard", None)
    return loop if shard is None else shard(name)


@dataclass
class NodeSpec:
    """Declarative ``WorkerNode`` shape: everything the constructor
    takes, minus the wiring a Platform owns (registry, services, loop,
    shared profiles). ``weight_store`` may be a ``WeightStore`` instance
    or a zero-argument factory (per-node stores)."""

    num_slots: int = 16
    comm_slots: int = 1
    backend: str = "dandelion"
    controller_enabled: bool = True
    controller_interval_s: float = 0.030
    max_retries: int = 2
    # node-wide RetryPolicy default (vertices may override); None keeps
    # the legacy max_retries behavior: zero backoff, timeouts fatal
    retry: Optional[RetryPolicy] = None
    hedge_after_s: float = 0.0
    cache_miss_rate: float = 0.0
    code_cache_entries: int = 0
    base_bytes: int = 0
    batch_slots: int = 0
    batch_model: Any = None
    # per-fn {fn_name: BatchStepModel}: multiplexed models on one node,
    # and the marker for *elastic* batch capability (work queues on the
    # BATCH engine even while the replica pool is scaled to zero)
    batch_models: Any = None
    max_batch: int = 32
    # RAM arena committed per batch replica (KV/activation working set)
    replica_bytes: int = 0
    weight_store: Any = None
    seed: int = 0
    # None -> auto-named: "node0" single, "node<i>" in a pool, control-
    # plane names ("en<i>") under Elastic
    name: Optional[str] = None

    def build(self, platform: "Platform",
              name: Optional[str] = None) -> WorkerNode:
        ws = self.weight_store() if callable(self.weight_store) \
            else self.weight_store
        name = name or self.name or "node0"
        return WorkerNode(
            platform.registry,
            platform.services,
            loop=_node_loop(platform.loop, name),
            num_slots=self.num_slots,
            comm_slots=self.comm_slots,
            backend=self.backend,
            profiles=platform.profiles,
            controller_enabled=self.controller_enabled,
            controller_interval_s=self.controller_interval_s,
            max_retries=self.max_retries,
            retry_policy=self.retry,
            hedge_after_s=self.hedge_after_s,
            cache_miss_rate=self.cache_miss_rate,
            code_cache_entries=self.code_cache_entries,
            base_bytes=self.base_bytes,
            batch_slots=self.batch_slots,
            batch_model=self.batch_model,
            batch_models=self.batch_models,
            max_batch=self.max_batch,
            replica_bytes=self.replica_bytes,
            weight_store=ws,
            seed=self.seed,
            name=name,
        )


@dataclass
class Elastic:
    """Elastic-cluster shape: an ``ElasticControlPlane`` over nodes built
    from ``node`` (names assigned by the control plane)."""

    config: ControlPlaneConfig = field(default_factory=ControlPlaneConfig)
    node: NodeSpec = field(default_factory=NodeSpec)
    seed: int = 0
    journal: bool = False


class InvocationHandle:
    """Future for one invocation: filled by the dispatcher's completion
    callback; ``result()`` drives the (virtual-time) loop to completion.
    ``cancel()`` revokes the request mid-flight (or before dispatch)."""

    def __init__(self, platform: "Platform", comp: Composition,
                 on_done: Optional[Callable] = None):
        self._platform = platform
        self.comp = comp
        self.invocation = None          # InvocationRun once finished
        self._on_done = on_done
        self._live_inv = None           # current live InvocationRun
        self._cancel_requested = False

    # dispatcher completion callback
    def _complete(self, inv) -> None:
        self.invocation = inv
        self._live_inv = None
        if self._on_done is not None:
            self._on_done(inv)

    # cluster admission callback: fires per attempt (incl. node-death
    # re-executions), so cancel() always reaches the CURRENT run
    def _started(self, inv) -> None:
        self._live_inv = inv
        if self._cancel_requested:
            inv.dispatcher.cancel(inv)

    @property
    def done(self) -> bool:
        """Completed successfully."""
        return self.invocation is not None and self.invocation.done

    @property
    def failed(self) -> Optional[str]:
        """Failure reason (names the failing vertex), or None."""
        return None if self.invocation is None else self.invocation.failed

    @property
    def cancelled(self) -> bool:
        """Cancellation took effect: revoked before dispatch, or the
        live run was torn down with kind "cancelled"."""
        if self.invocation is not None:
            return self.invocation.failure_kind == "cancelled"
        return self._cancel_requested

    def cancel(self) -> bool:
        """Revoke this request. Mid-flight, the dispatcher flushes its
        queued vertices, marks its live engine tasks cancelled, and
        releases contexts and weight refcounts exactly once; before the
        scheduled fire time (``invoke(at=...)``), the dispatch is simply
        skipped. Returns False if the invocation already finished."""
        if self.invocation is not None:
            return False
        self._cancel_requested = True
        inv = self._live_inv
        if inv is None:
            return True     # not fired yet; _fire will skip the dispatch
        return inv.dispatcher.cancel(inv)

    @property
    def outputs(self) -> SetDict:
        return {} if self.invocation is None else self.invocation.outputs

    @property
    def latency(self) -> Optional[float]:
        return None if self.invocation is None else self.invocation.latency

    def result(self, until: Optional[float] = None) -> SetDict:
        """Output sets of the finished invocation; drives the platform
        loop (to ``until``) if still pending. Raises ``InvocationFailed``
        on failure or if the loop drains without completing it."""
        if self.invocation is None:
            self._platform.run(until=until)
        if self.invocation is None:
            if until is not None:
                # not a failure: the horizon cut the run short
                raise InvocationFailed(
                    f"{self.comp.name}: invocation still pending at "
                    f"t={until}; run() further or call result() again"
                )
            raise InvocationFailed(
                f"{self.comp.name}: loop drained without completing the "
                f"invocation"
            )
        if self.invocation.failed:
            raise InvocationFailed(
                f"{self.comp.name}: {self.invocation.failed}"
            )
        return self.invocation.outputs


class Platform:
    """Owns registries, services, the event loop, and one execution
    backend (single node / static pool / elastic cluster). See module
    docstring for the lifecycle."""

    def __init__(
        self,
        *,
        node: Optional[NodeSpec] = None,
        pool: Optional[List[NodeSpec]] = None,
        elastic: Optional[Elastic] = None,
        registry: Optional[FunctionRegistry] = None,
        services: Optional[ServiceRegistry] = None,
        loop: Optional[EventLoop] = None,
        profiles: Optional[Dict[str, ColdStartProfile]] = None,
        crossnode: Optional[bool] = None,
        transfer_links: Optional[Dict[Tuple[str, str], TransferProfile]] = None,
        transfer_profile: Optional[TransferProfile] = None,
        memoize: bool = True,
        restart_attempts: int = 3,
        route_policy: str = "outstanding",
        batch_router: Any = None,
        crossnode_spread: Optional[bool] = None,
        config: Optional[PlatformConfig] = None,
        verify: Optional[str] = None,
    ):
        shapes = [s for s in (node, pool, elastic) if s is not None]
        if len(shapes) > 1:
            raise DeploymentError(
                "pass exactly one of node=, pool=, elastic= (default: one "
                "node)"
            )
        if pool is not None and not pool:
            raise DeploymentError("pool= needs at least one NodeSpec")
        # one validated parse of the env spelling when no explicit config
        # is passed; explicit Platform kwargs layer on top either way
        if config is None:
            config = PlatformConfig.from_env(warn_deprecated=True)
        self.config = config.with_overrides(
            crossnode=crossnode, crossnode_spread=crossnode_spread,
            verify=verify,
        )
        crossnode = self.config.crossnode
        crossnode_spread = self.config.crossnode_spread
        if pool is None and elastic is None and (
            crossnode or transfer_links or transfer_profile
        ):
            raise DeploymentError(
                "crossnode/transfer options need a cluster shape "
                "(pool= or elastic=); a single node has no peers"
            )
        if pool is None and elastic is None and self.config.prefetch:
            raise DeploymentError(
                "PlatformConfig.prefetch needs a cluster shape "
                "(pool= or elastic=); a single node has no peers to warm"
            )
        if elastic is None and self.config.predictor:
            raise DeploymentError(
                "PlatformConfig.predictor needs the elastic shape; "
                "prediction drives node boots"
            )
        self._node_spec = node if shapes else NodeSpec()
        self._pool_specs = list(pool) if pool is not None else None
        self._elastic = elastic
        self.registry = registry or FunctionRegistry(memoize=memoize)
        self.services = services or ServiceRegistry()
        self.loop = loop if loop is not None else self.config.build_loop()
        # shared per-function dispatcher profiles: deploy() merges each
        # spec's calibrated profile in-place, so nodes built later (and
        # the elastic factory's nodes) all read the same dict
        self.profiles: Dict[str, ColdStartProfile] = \
            profiles if profiles is not None else {}
        if route_policy not in ("outstanding", "batch_aware"):
            raise DeploymentError(f"unknown route_policy {route_policy!r}")
        if route_policy != "outstanding" and pool is None and elastic is None:
            raise DeploymentError(
                "route_policy= needs a cluster shape (pool= or elastic=); "
                "a single node has nothing to route over"
            )
        self._crossnode = crossnode
        self._crossnode_spread = crossnode_spread
        self._route_policy = route_policy
        self._batch_router = batch_router
        self._transfer_links = transfer_links
        self._transfer_profile = transfer_profile
        # node-death re-execution budget for cluster shapes
        self._restart_attempts = restart_attempts
        self._worker: Optional[WorkerNode] = None
        self._cluster: Optional[ClusterManager] = None
        self._cp: Optional[ElasticControlPlane] = None
        self._built = False
        # most recent deploy-time PurityReport (None before any deploy
        # or with verify="off")
        self.last_verify_report = None

    # ------------------------------------------------------- deployment
    def service(self, host: str, handler, **kwargs) -> None:
        """Register an external HTTP service endpoint (see
        ``ServiceRegistry.register`` for latency/bandwidth knobs)."""
        self.services.register(host, handler, **kwargs)

    def deploy(self, target, *,
               profiles: Optional[Dict[str, ColdStartProfile]] = None):
        """Make an application invokable: register its function
        declarations (payloads, metadata, calibrated profiles) and its
        validated composition. Accepts an ``App``, a raw IR
        ``Composition`` (functions must already be registered), or a bare
        ``FunctionSpec``. Returns the registered ``Composition`` (or
        ``ComputeFunction`` for a bare spec). ``profiles`` overrides /
        extends the per-function dispatcher profiles."""
        if isinstance(target, FunctionSpec):
            if target.is_ref and target.name not in self.registry.functions:
                raise DeploymentError(
                    f"sdk.ref {target.name!r} does not resolve: no such "
                    f"function registered on this platform"
                )
            self._verify_gate(target)
            cf = self._register_spec(target)
            self._merge_profiles(profiles)
            return cf
        if isinstance(target, App):
            comp = target.compile(self.registry)
            self._verify_gate(target)
            for spec in target.function_specs():
                self._register_spec(spec)
        elif isinstance(target, Composition):
            comp = target
            self._verify_gate(comp)
        else:
            raise DeploymentError(
                f"deploy() takes an App, Composition, or FunctionSpec, "
                f"got {type(target).__name__}"
            )
        try:
            self.registry.register_composition(comp)
        except ValueError as e:
            raise DeploymentError(str(e)) from e
        self._merge_profiles(profiles)
        return comp

    def _verify_gate(self, target) -> None:
        """Deploy-time purity verification (the ``verify=`` knob):
        ``off`` skips analysis entirely, ``warn`` (default) emits one
        ``UserWarning`` naming the violations, ``strict`` raises
        ``sdk.PurityError``. The report (including waived findings and
        ``pure_unsafe`` opt-outs) is kept on ``last_verify_report``."""
        mode = self.config.verify or "warn"
        if mode == "off":
            return
        from repro_torch.sdk.verify import verify as _verify

        report = _verify(
            target, registry=self.registry,
            cluster=self._pool_specs is not None or self._elastic is not None,
            crossnode=bool(self._crossnode),
        )
        self.last_verify_report = report
        if not report.blocking:
            return
        if mode == "strict":
            raise PurityError(report)
        warnings.warn(
            "purity verification found "
            f"{len(report.blocking)} violation(s) "
            "(deploying anyway; Platform(verify='strict') rejects):\n"
            + "\n".join(f.render() for f in report.blocking),
            stacklevel=3,
        )

    def _register_spec(self, spec: FunctionSpec):
        if spec.is_ref:
            # reference to a function registered out-of-band; the
            # composition registration below checks it resolves
            return None
        existing = self.registry.functions.get(spec.name)
        if existing is not None:
            if not _same_payload(existing.fn, spec.fn):
                raise DeploymentError(
                    f"function {spec.name!r} already registered with a "
                    f"different payload; function names are global to a "
                    f"platform"
                )
            cf = existing              # idempotent re-deploy
        else:
            cf = spec.register_into(self.registry)
        if spec.profile is not None:
            self.profiles[spec.name] = spec.profile
        return cf

    def _merge_profiles(self, profiles) -> None:
        if profiles:
            self.profiles.update(profiles)

    # ---------------------------------------------------------- backend
    def _build(self) -> None:
        if self._built:
            return
        self._built = True
        distributor = None
        if self.config.prefetch is not None:
            from repro_torch.core.artifacts import P2PDistributor
            distributor = P2PDistributor(
                self.loop, config=self.config.prefetch
            )
        if self._elastic is not None:
            e = self._elastic
            cp_cfg = e.config
            if self._route_policy == "batch_aware":
                # compose batch-aware routing with node autoscaling; the
                # default "outstanding" leaves the elastic config (and
                # its byte-pinned decision stream) untouched
                cp_cfg = dataclasses.replace(
                    cp_cfg, route_policy="batch_aware",
                    batch_router=self._batch_router or cp_cfg.batch_router,
                )
            self._cp = ElasticControlPlane(
                self.loop,
                lambda name: e.node.build(self, name=name),
                config=cp_cfg,
                seed=e.seed,
                journal=e.journal,
                predictor=self.config.predictor,
                distributor=distributor,
            )
            self._cluster = ClusterManager(
                control_plane=self._cp,
                crossnode=self._crossnode,
                crossnode_spread=self._crossnode_spread,
                transfer_links=self._transfer_links,
                transfer_profile=self._transfer_profile,
                restart_attempts=self._restart_attempts,
                distributor=distributor,
            )
        elif self._pool_specs is not None:
            # auto-name unnamed specs by position; explicit duplicate
            # names would corrupt per-link transfer accounting
            nodes = [
                spec.build(self, name=f"node{i}" if spec.name is None
                           else None)
                for i, spec in enumerate(self._pool_specs)
            ]
            names = [n.name for n in nodes]
            if len(set(names)) != len(names):
                raise DeploymentError(
                    f"pool node names must be unique, got {names}"
                )
            self._cluster = ClusterManager(
                nodes, self.loop,
                crossnode=self._crossnode,
                crossnode_spread=self._crossnode_spread,
                transfer_links=self._transfer_links,
                transfer_profile=self._transfer_profile,
                restart_attempts=self._restart_attempts,
                route_policy=self._route_policy,
                batch_router=self._batch_router,
                distributor=distributor,
            )
        else:
            self._worker = self._node_spec.build(self)

    @property
    def node(self) -> Optional[WorkerNode]:
        """The single worker node (single-node shape only)."""
        self._build()
        return self._worker

    @property
    def nodes(self) -> List[WorkerNode]:
        """All worker nodes currently up."""
        self._build()
        if self._worker is not None:
            return [self._worker]
        return self._cluster.nodes

    @property
    def cluster(self) -> Optional[ClusterManager]:
        self._build()
        return self._cluster

    @property
    def control_plane(self) -> Optional[ElasticControlPlane]:
        self._build()
        return self._cp

    @property
    def placer(self):
        """The ``CrossNodePlacer`` when cross-node scheduling is on."""
        self._build()
        return None if self._cluster is None else self._cluster.placer

    @property
    def distributor(self):
        """The ``P2PDistributor`` when ``PlatformConfig.prefetch`` is
        set, or None."""
        self._build()
        return None if self._cluster is None else self._cluster.distributor

    @property
    def predictor(self):
        """The elastic shape's ``BurstPredictor`` when
        ``PlatformConfig.predictor`` is set, or None."""
        self._build()
        return None if self._cp is None else self._cp.predictor

    @property
    def replica_autoscaler(self):
        """The elastic shape's ``ReplicaAutoscaler`` (batch-replica
        scaling), or None when not configured
        (``ControlPlaneConfig.replicas``)."""
        self._build()
        return None if self._cp is None else self._cp.replica_autoscaler

    @property
    def latency(self):
        """End-to-end latency stats at this platform's front door."""
        self._build()
        if self._worker is not None:
            return self._worker.latency
        return self._cluster.latency

    # -------------------------------------------------------- invocation
    def _comp(self, target) -> Composition:
        if isinstance(target, App):
            return target.compile()
        if isinstance(target, Composition):
            return target
        raise DeploymentError(
            f"expected an App or Composition, got {type(target).__name__}"
        )

    def _fire(self, comp: Composition, inputs: SetDict,
              on_done: Optional[Callable],
              handle: Optional[InvocationHandle] = None) -> None:
        if self._worker is not None:
            inv = self._worker.invoke(comp, inputs, on_done=on_done)
            if handle is not None and not inv.done and not inv.failed:
                handle._started(inv)
        else:
            # on_start fires per admission (including node-death
            # re-executions), keeping handle.cancel() aimed at the
            # current live run
            on_start = None if handle is None else handle._started
            self._cluster.invoke(comp, inputs, on_done=on_done,
                                 on_start=on_start)

    def invoke(
        self,
        app,
        inputs: Optional[SetDict] = None,
        *,
        at: Optional[float] = None,
        on_done: Optional[Callable] = None,
    ) -> InvocationHandle:
        """Invoke an application (now, or at virtual time ``at``) and
        return a handle. Works identically on all three backend shapes;
        ``on_done(inv)`` additionally fires on completion if given."""
        self._build()
        comp = self._comp(app)
        handle = InvocationHandle(self, comp, on_done)
        inputs = inputs or {}
        if at is None:
            self._fire(comp, inputs, handle._complete, handle=handle)
        else:
            def fire():
                if handle._cancel_requested:
                    return      # cancelled before the scheduled dispatch
                self._fire(comp, inputs, handle._complete, handle=handle)

            self.loop.at(at, fire)
        return handle

    def submit_stream(self, arrivals) -> None:
        """Bulk trace injection: ``arrivals`` is a time-sorted iterable
        of ``(t, app, inputs)`` or ``(t, app, inputs, on_done)`` tuples,
        replayed through one heap cursor (``EventLoop.at_stream``) — the
        fast path for trace-scale workloads. No handles are created; use
        per-arrival ``on_done`` callbacks to observe completions."""
        self._build()

        def norm():
            for a in arrivals:
                if len(a) == 3:
                    t, app, inputs = a
                    cb = None
                else:
                    t, app, inputs, cb = a
                yield t, (self._comp(app), inputs, cb)

        self.loop.at_stream(
            norm(), lambda cic: self._fire(cic[0], cic[1], cic[2])
        )

    def run(self, until: Optional[float] = None) -> None:
        """Drive the virtual-time loop (to ``until``, or until idle)."""
        self._build()
        self.loop.run(until=until)
