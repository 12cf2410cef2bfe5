"""Content-addressed artifact catalog + P2P tree distribution (FaaSNet).

A freshly booted node pays per-function disk misses and full model-weight
cold starts on first touch, so scale-up is slowest exactly when bursts
hit. FaaSNet's answer (Alibaba Function Compute, see PAPERS.md) is to
provision function artifacts peer-to-peer over a tree of already-warm
nodes instead of hammering the origin registry. This module models both
halves:

  * ``ArtifactCatalog`` — content-addressed artifacts with *real* sizes:
    function binaries straight from the ``FunctionRegistry`` code store
    (``len(ComputeFunction.code)``) and model weights from a node's
    ``WeightStore`` registration (``param_bytes``). The digest is the
    content address; two registrations of the same bytes are one
    artifact.
  * ``P2PDistributor`` — on node join (or an explicit prefetch decision)
    streams hot artifacts to the new node. Every stream is an explicit
    ``TRANSFER`` task on the *sending* node's comm engine, priced by the
    per-link ``TransferProfile`` — distribution contends with real
    traffic and is journaled/byte-deterministic exactly like cross-node
    edges (``cluster.CrossNodePlacer``). Peers serve at most
    ``fanout`` concurrent downloads per artifact; a node that finishes
    its download immediately becomes a serving peer for nodes still
    waiting — the FaaSNet tree, built dynamically and deterministically.
    With no warm peer (or ``peer=False``, the baseline) the artifact is
    fetched from the origin registry, whose single uplink serializes
    concurrent downloads — the bottleneck P2P exists to remove.

Arrived artifacts seed the receiving node through the existing cold-start
accounting so nothing is double-billed: code binaries enter the node's
``CodeCache`` via ``warm()`` (residency without a counted hit/miss) and
weights enter the ``WeightStore`` via ``preload()`` (residency committed
once, no cold touch) — the next request's ``touch`` probes see warm state
and the task's ``cold_setup_s`` is never charged a second time.

Contract / determinism invariants:

  * source selection, tree shape, and transfer durations are pure
    functions of catalog content, join order, and link profiles — no RNG;
    the journal is byte-stable run to run, under both ``CROSSNODE``
    values and the sharded loop (pinned by tests/test_prefetch.py);
  * in-flight bytes are staged in a ``MemoryContext`` on the sender and
    released on arrival (weights re-commit through the store's own
    residency accounting — freed-exactly-once holds through prefetch);
  * with no distributor attached (the default), no code path changes:
    fig10–13 byte-identity is untouched.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.coldstart import TransferProfile
from repro_torch.core.context import MemoryContext
from repro_torch.core.engines import TRANSFER, Task
from repro_torch.core.node import WorkerNode
from repro_torch.core.tracing import TransferStats

CODE, WEIGHTS = "code", "weights"

#: pseudo-node name for origin-registry fetches in journals/link counters
ORIGIN = "origin"


@dataclass(frozen=True)
class Artifact:
    """One distributable blob: a function binary or a model's weights."""

    name: str                  # "code:<fn_name>" | "weights:<model>"
    kind: str                  # CODE | WEIGHTS
    nbytes: int                # real size (code bytes / param bytes)
    fn_names: Tuple[str, ...]  # functions this artifact warms
    digest: str                # content address

    @property
    def key(self) -> str:
        """The registry-level identity (fn name or model name)."""
        return self.name.split(":", 1)[1]


def _digest(kind: str, key: str, nbytes: int) -> str:
    return hashlib.sha256(f"{kind}:{key}:{nbytes}".encode()).hexdigest()[:16]


class ArtifactCatalog:
    """Content-addressed index of everything the distributor may stream.

    Registration is idempotent per (kind, key, size): re-syncing from a
    registry or weight store never duplicates an artifact, and a size
    change (a redeployed binary) produces a *new* digest — the content
    address is the identity, as in any CAS registry.
    """

    def __init__(self):
        self._by_name: Dict[str, Artifact] = {}   # insertion-ordered

    def __len__(self) -> int:
        return len(self._by_name)

    def __iter__(self):
        return iter(self._by_name.values())

    def get(self, name: str) -> Optional[Artifact]:
        return self._by_name.get(name)

    # ---------------------------------------------------- registration
    def register_code(self, fn_name: str, nbytes: int) -> Artifact:
        name = f"{CODE}:{fn_name}"
        art = Artifact(name=name, kind=CODE, nbytes=int(nbytes),
                       fn_names=(fn_name,),
                       digest=_digest(CODE, fn_name, int(nbytes)))
        self._by_name[name] = art
        return art

    def register_weights(self, model: str, param_bytes: int,
                         fn_names) -> Artifact:
        name = f"{WEIGHTS}:{model}"
        art = Artifact(name=name, kind=WEIGHTS, nbytes=int(param_bytes),
                       fn_names=tuple(fn_names),
                       digest=_digest(WEIGHTS, model, int(param_bytes)))
        self._by_name[name] = art
        return art

    def sync_registry(self, registry) -> None:
        """Register every compute function's binary at its real size."""
        for fn_name, cf in registry.functions.items():
            existing = self._by_name.get(f"{CODE}:{fn_name}")
            nbytes = max(len(cf.code), 1)
            if existing is None or existing.nbytes != nbytes:
                self.register_code(fn_name, nbytes)

    def sync_weight_store(self, ws) -> None:
        """Register every model a ``WeightStore`` knows, with the compute
        functions mapped to it, at its registered ``param_bytes``."""
        if ws is None:
            return
        by_model: Dict[str, List[str]] = {}
        for fn, model in ws._by_fn.items():
            by_model.setdefault(model, []).append(fn)
        for model, st in ws._models.items():
            fns = tuple(sorted(by_model.get(model, ())))
            existing = self._by_name.get(f"{WEIGHTS}:{model}")
            if existing is None or existing.nbytes != st.param_bytes \
                    or existing.fn_names != fns:
                self.register_weights(model, st.param_bytes, fns)

    # --------------------------------------------------------- queries
    def for_functions(self, fn_names) -> List[Artifact]:
        """Artifacts needed to serve ``fn_names`` warm, in registration
        order: each function's binary plus the weights of any model
        mapped to it."""
        wanted = set(fn_names)
        return [a for a in self._by_name.values()
                if wanted.intersection(a.fn_names)]


@dataclass
class PrefetchConfig:
    """Knobs for P2P artifact distribution (``P2PDistributor``). Ships
    only through ``sdk.PlatformConfig(prefetch=...)``."""

    hot_k: int = 8              # top-K hot functions prefetched on join
    fanout: int = 2             # concurrent downloads one peer serves
    peer: bool = True           # False -> origin-only fetch (baseline)
    include_weights: bool = True
    # peer links default to the cross-node TransferProfile; the origin
    # registry's shared uplink is slower per FaaSNet's motivation
    peer_link: TransferProfile = field(default_factory=TransferProfile)
    origin_link: TransferProfile = field(
        default_factory=lambda: TransferProfile(
            latency_s=1e-3, bandwidth_bps=256e6
        )
    )
    journal: bool = False

    def __post_init__(self):
        if self.hot_k < 1:
            raise ValueError(f"prefetch hot_k must be >= 1, got {self.hot_k}")
        if self.fanout < 1:
            raise ValueError(f"prefetch fanout must be >= 1, got {self.fanout}")


class _ArtifactFlow:
    """Per-artifact distribution state: which nodes hold a complete copy,
    which are mid-download, and who is queued waiting for a serving slot."""

    __slots__ = ("holders", "inflight", "outbound", "queue")

    def __init__(self):
        self.holders: List[WorkerNode] = []     # completed copies, in order
        self.inflight: set = set()              # node ids mid-download
        self.outbound: Dict[int, int] = {}      # holder id -> live streams
        self.queue: List[Tuple[WorkerNode, Callable[[], None]]] = []


class P2PDistributor:
    """Streams catalog artifacts to joining/prefetching nodes over a
    deterministic tree of warm peers. See module docstring."""

    def __init__(
        self,
        loop,
        catalog: Optional[ArtifactCatalog] = None,
        *,
        config: Optional[PrefetchConfig] = None,
        journal: Optional[bool] = None,
    ):
        self.loop = loop
        self.catalog = catalog or ArtifactCatalog()
        self.cfg = config or PrefetchConfig()
        if journal is None:
            journal = self.cfg.journal
        self.journal: Optional[List[str]] = [] if journal else None
        self.stats = TransferStats()
        self.peer_fetches = 0
        self.origin_fetches = 0
        self.joins = 0
        #: (node name, join time, warm latency seconds) per completed join
        self.join_log: List[Tuple[str, float, float]] = []
        self._flows: Dict[str, _ArtifactFlow] = {}
        self._origin_free_t = 0.0   # single origin uplink: FIFO in time

    # ------------------------------------------------------------------
    def _log(self, msg: str):
        if self.journal is not None:
            self.journal.append(f"{self.loop.now:.9f} {msg}")

    def _flow(self, art: Artifact) -> _ArtifactFlow:
        f = self._flows.get(art.digest)
        if f is None:
            f = self._flows[art.digest] = _ArtifactFlow()
        return f

    # ------------------------------------------------------- residency
    @staticmethod
    def node_has(node: WorkerNode, art: Artifact) -> bool:
        """Whether ``node`` already holds ``art`` resident."""
        if art.kind == CODE:
            cc = node.code_cache
            return cc is None or cc.resident(art.key)
        ws = node.weight_store
        if ws is None or art.key not in ws._models:
            return False
        return ws.resident(art.key)

    def _seed(self, node: WorkerNode, art: Artifact) -> None:
        """Mark ``art`` resident on ``node`` through the cold-start
        accounting: the next dispatcher ``touch`` is a warm hit, so the
        profile's ``cold_setup_s`` is never billed on top of the
        transfer the artifact already paid."""
        if art.kind == CODE:
            if node.code_cache is not None:
                for fn in art.fn_names:
                    node.code_cache.warm(fn)
        else:
            ws = node.weight_store
            if ws is not None and art.key in ws._models:
                ws.preload(art.key)

    def scan_holders(self, nodes) -> None:
        """Index already-warm nodes as serving peers (seed nodes warmed
        through ordinary traffic rather than through a prefetch)."""
        for art in self.catalog:
            flow = self._flow(art)
            held = {id(n) for n in flow.holders}
            for n in nodes:
                if id(n) not in held and n.alive and self.node_has(n, art):
                    flow.holders.append(n)

    # ------------------------------------------------------ entrypoints
    def on_node_join(self, node: WorkerNode, *, peers, hot_fns=None,
                     on_complete: Optional[Callable[[float], None]] = None):
        """A node joined the pool: sync the catalog from what it can run,
        index the existing ``peers`` as serving candidates, and stream it
        the hot artifact set. ``hot_fns`` (e.g. from
        ``RoutingStats.hot_functions``) narrows the set; None prefetches
        the whole catalog. ``on_complete(warm_s)`` fires when every
        artifact has landed."""
        self.catalog.sync_registry(node.registry)
        self.catalog.sync_weight_store(node.weight_store)
        self.scan_holders(list(peers) + [node])
        arts = (self.catalog.for_functions(hot_fns) if hot_fns is not None
                else list(self.catalog))
        if not self.cfg.include_weights:
            arts = [a for a in arts if a.kind != WEIGHTS]
        self.joins += 1
        t0 = self.loop.now
        self._log(f"join {node.name} artifacts={len(arts)}")

        def done():
            warm_s = self.loop.now - t0
            self.join_log.append((node.name, t0, warm_s))
            self._log(f"join_warm {node.name} warm_s={warm_s:.9f}")
            if on_complete is not None:
                on_complete(warm_s)

        self.prefetch(node, arts, on_complete=done)

    def prefetch(self, node: WorkerNode, artifacts,
                 on_complete: Optional[Callable[[], None]] = None):
        """Stream ``artifacts`` to ``node``; ``on_complete`` fires once
        all of them are resident there (immediately if they already are)."""
        pending = 0
        fired = [False]

        def one_done():
            nonlocal pending
            pending -= 1
            if pending == 0 and not fired[0]:
                fired[0] = True
                if on_complete is not None:
                    on_complete()

        artifacts = list(artifacts)
        for art in artifacts:
            flow = self._flow(art)
            if self.node_has(node, art) or id(node) in flow.inflight:
                continue
            pending += 1
            flow.inflight.add(id(node))
            flow.queue.append((node, one_done))
        if pending == 0:
            if on_complete is not None:
                on_complete()
            return
        for art in artifacts:
            self._drain(art)

    # ------------------------------------------------------ tree engine
    def _drain(self, art: Artifact) -> None:
        """Start every queued download of ``art`` that has a serving slot:
        warm holders first (up to ``fanout`` concurrent streams each, in
        stable holder order), the origin uplink as the fallback root."""
        flow = self._flow(art)
        while flow.queue:
            dst, cb = flow.queue[0]
            if not dst.alive:
                flow.queue.pop(0)
                flow.inflight.discard(id(dst))
                cb()
                continue
            src = None
            if self.cfg.peer:
                for h in flow.holders:
                    if h.alive and h is not dst \
                            and flow.outbound.get(id(h), 0) < self.cfg.fanout:
                        src = h
                        break
            if src is not None:
                flow.queue.pop(0)
                self._stream_peer(art, flow, src, dst, cb)
            elif not flow.holders or not self.cfg.peer:
                flow.queue.pop(0)
                self._stream_origin(art, flow, dst, cb)
            else:
                # warm peers exist but all fanout slots are busy: wait for
                # a stream to finish (the finisher re-drains the queue)
                return

    def _arrived(self, art: Artifact, flow: _ArtifactFlow,
                 dst: WorkerNode, cb: Callable[[], None]) -> None:
        flow.inflight.discard(id(dst))
        if dst.alive:
            self._seed(dst, art)
            flow.holders.append(dst)    # dst now serves the tree
        cb()
        self._drain(art)

    def _stream_peer(self, art: Artifact, flow: _ArtifactFlow,
                     src: WorkerNode, dst: WorkerNode,
                     cb: Callable[[], None]) -> None:
        cpu_s, io_s = self.cfg.peer_link.charge(art.nbytes)
        self.peer_fetches += 1
        flow.outbound[id(src)] = flow.outbound.get(id(src), 0) + 1
        self.stats.record_transfer(src.name, dst.name, art.nbytes, cpu_s, io_s)
        self._log(f"transfer {art.name} {src.name}->{dst.name} "
                  f"bytes={art.nbytes}")
        # stage the in-flight bytes on the sender for the wire time; the
        # receiver's residency is committed by _seed through the
        # CodeCache/WeightStore accounting (never both at once)
        stage = MemoryContext(capacity=max(art.nbytes, 1),
                              tracker=src.tracker)
        stage.load_code_size(art.nbytes)

        def landed(_task: Task, _outputs, _ctx):
            stage.free()
            flow.outbound[id(src)] -= 1
            self._arrived(art, flow, dst, cb)

        src.engines.submit(Task(
            kind=TRANSFER, fn_name="transfer", inputs={}, context_bytes=0,
            transfer_bytes=art.nbytes, transfer_cpu_s=cpu_s,
            transfer_io_s=io_s, on_complete=landed,
        ))

    def _stream_origin(self, art: Artifact, flow: _ArtifactFlow,
                       dst: WorkerNode, cb: Callable[[], None]) -> None:
        cpu_s, io_s = self.cfg.origin_link.charge(art.nbytes)
        self.origin_fetches += 1
        # the origin registry has ONE shared uplink: concurrent fetches
        # serialize in FIFO order (the scale bottleneck FaaSNet removes)
        start = max(self.loop.now, self._origin_free_t)
        self._origin_free_t = start + io_s
        self.stats.record_transfer(ORIGIN, dst.name, art.nbytes, cpu_s, io_s)
        self._log(f"origin_fetch {art.name} ->{dst.name} bytes={art.nbytes} "
                  f"start={start:.9f}")

        def landed(_task: Task, _outputs, _ctx):
            self._arrived(art, flow, dst, cb)

        def submit():
            if not dst.alive:
                self._arrived(art, flow, dst, cb)
                return
            # the download occupies the RECEIVER's comm engine (protocol
            # CPU + wire time), contending with its real traffic
            dst.engines.submit(Task(
                kind=TRANSFER, fn_name="transfer", inputs={},
                context_bytes=0, transfer_bytes=art.nbytes,
                transfer_cpu_s=cpu_s, transfer_io_s=io_s,
                on_complete=landed,
            ))

        if start <= self.loop.now:
            submit()
        else:
            self.loop.at(start, submit)

    # ------------------------------------------------------------ stats
    def summary(self) -> Dict[str, float]:
        warms = [w for _, _, w in self.join_log]
        return {
            "artifacts": len(self.catalog),
            "joins": self.joins,
            "peer_fetches": self.peer_fetches,
            "origin_fetches": self.origin_fetches,
            "transfer_mb": self.stats.bytes_total / 1024**2,
            "join_warm_max_s": max(warms) if warms else 0.0,
            "join_warm_avg_s": sum(warms) / len(warms) if warms else 0.0,
        }
