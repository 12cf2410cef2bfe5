"""Platform-layer support for serving-style workloads (SS4 "higher-level
services": AI inference as a composition over the elastic platform).

Two pieces the serving-on-Dandelion workload needs that generic
compositions do not:

``BatchStepModel``
    Roofline-derived duration model for one *coalesced* batch step on a
    node's batching engine (``engines.BATCH``): co-resident decode
    vertices from different requests run as ONE modeled step whose
    duration is ``max(compute, memory) + overhead`` — the fixed
    weight-read term amortizes over the batch, so elastic scale-out
    trades batch efficiency against queueing (the paper's fig-8
    multiplexing story at cluster scale). The terms come from the
    trace-capture calibration in ``repro_torch.serving.trace_capture``
    (CUDA-event step times); this class keeps only plain floats so core
    stays below the serving layer.

``WeightStore``
    Per-node model-weight residency: the multi-GB weight term that
    FaaSNet-style provisioning identifies as the dominant cold-start
    cost. Weights commit on first touch (the request then pays the
    profile's ``cold_setup_s`` — load from disk + compile) and are
    released once no request holds them and they have sat idle past the
    keep-alive. ``pinned=True`` models a keep-warm replica: committed
    from bind to the end of the run. Inflight refcounts guarantee a
    request never loses its weights between two back-to-back decode
    steps even at ``keepalive_s=0`` (the per-request-cold policy).

    With ``capacity_bytes`` set, the store also models node-RAM
    contention between multiplexed models: a commit that would exceed
    capacity first evicts resident *idle* models (``inflight == 0``,
    never pinned) in least-recently-touched order, registration order
    breaking exact-time ties — the documented deterministic policy the
    multiplexing tests pin. A task that has touched its model holds an
    inflight reference until ``task_done``, so eviction can never take
    weights out from under a queued or running step.

Contract / determinism invariants:

  * ``WeightStore`` commits/releases through the node's
    ``MemoryTracker`` only — committed bytes return to the pre-bind
    level once every request completes and keep-alives expire (the
    freed-exactly-once contract, pinned by
    tests/test_inference_service.py);
  * ``BatchStepModel.step_s`` is pure arithmetic on the batch size: no
    RNG, so batch-step durations are byte-stable run to run;
  * reap events are daemon events on the virtual loop: they never keep
    a simulation alive.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from repro_torch.core.context import MemoryTracker
from repro_torch.core.sim import EventLoop


@dataclass(frozen=True)
class BatchStepModel:
    """Step time of one coalesced batch of ``n`` co-resident sequences.

    ``compute_s(n) = n * flops_per_seq / peak_flops`` (each sequence adds
    its own matmul work) vs ``memory_s(n) = (fixed_bytes + n *
    bytes_per_seq) / hbm_bw`` (the weight read is paid once per step, KV
    traffic per sequence) — decode is memory-bound at small ``n``, which
    is exactly why continuous batching wins: ``step_s(8) << 8 *
    step_s(1)``."""

    flops_per_seq: float        # FLOPs one sequence adds to the step
    fixed_bytes: float          # HBM bytes read once per step (weights)
    bytes_per_seq: float        # HBM bytes each sequence adds (KV cache)
    peak_flops: float
    hbm_bw: float
    overhead_s: float = 0.0     # per-step dispatch/kernel-launch floor

    def compute_s(self, batch: int) -> float:
        return batch * self.flops_per_seq / self.peak_flops

    def memory_s(self, batch: int) -> float:
        return (self.fixed_bytes + batch * self.bytes_per_seq) / self.hbm_bw

    def step_s(self, batch: int) -> float:
        """Roofline step time for a batch of ``batch`` sequences."""
        if batch <= 0:
            return 0.0
        return max(self.compute_s(batch), self.memory_s(batch)) + self.overhead_s

    def step_s_batch(self, batches) -> np.ndarray:
        """Vectorized ``step_s`` over an array of batch sizes: one numpy
        pass prices N coalesced steps (decode-chain replay, calibration
        sweeps, live telemetry) instead of N Python-level calls. Matches
        ``step_s`` element-for-element (pinned by tests)."""
        n = np.asarray(batches, dtype=np.float64)
        roof = np.maximum(
            n * self.flops_per_seq / self.peak_flops,
            (self.fixed_bytes + n * self.bytes_per_seq) / self.hbm_bw,
        )
        return np.where(n > 0, roof + self.overhead_s, 0.0)

    def amortization(self, batch: int) -> float:
        """Throughput multiplier of batching: ``batch * step_s(1) /
        step_s(batch)`` — the efficiency elastic scale-out trades away
        when it spreads co-resident sequences over more nodes."""
        if batch <= 0:
            return 1.0
        return batch * self.step_s(1) / self.step_s(batch)


@dataclass
class _ModelState:
    param_bytes: int
    resident: bool = False
    inflight: int = 0          # tasks submitted, not yet completed/failed
    idle_since: float = 0.0
    touches: int = 0
    cold_touches: int = 0
    last_touch_t: float = 0.0  # LRU clock for capacity eviction
    evictions: int = 0


class WeightStore:
    """Per-node model-weight residency with keep-alive release.

    Construct once per node, ``register`` each model with the compute
    functions that need it, and hand the store to the node
    (``WorkerNode(weight_store=...)``); the node binds it to its loop
    and memory tracker. The dispatcher then calls ``touch`` at instance
    submit (a miss commits the weights and returns False, so the task's
    ``cold_setup_s`` is charged) and ``task_done`` when the task
    completes, fails, or is cancelled.
    """

    def __init__(
        self,
        *,
        keepalive_s: float = 0.0,
        pinned: bool = False,
        capacity_bytes: Optional[int] = None,
    ):
        self.keepalive_s = keepalive_s
        self.pinned = pinned
        self.capacity_bytes = capacity_bytes
        self.loop: Optional[EventLoop] = None
        self.tracker: Optional[MemoryTracker] = None
        self._models: Dict[str, _ModelState] = {}
        self._by_fn: Dict[str, str] = {}     # fn_name -> model name
        self._reg_order: Dict[str, int] = {}  # model -> registration index
        self.evictions = 0
        self.evicted_bytes = 0
        self.over_capacity = 0   # commits forced past capacity (no victim)
        self.eviction_log: list = []         # (virtual t, model) journal

    # ------------------------------------------------------------------
    def register(self, model: str, param_bytes: int, fn_names) -> None:
        st = self._models.setdefault(model, _ModelState(param_bytes=param_bytes))
        st.param_bytes = param_bytes
        self._reg_order.setdefault(model, len(self._reg_order))
        for fn in fn_names:
            self._by_fn[fn] = model

    def bind(self, loop: EventLoop, tracker: MemoryTracker) -> None:
        """Attach to the owning node. Pinned stores commit every model's
        weights immediately (the keep-warm replica holds them for the
        whole run)."""
        self.loop = loop
        self.tracker = tracker
        if self.pinned:
            for st in self._models.values():
                if not st.resident:
                    st.resident = True
                    tracker.commit(st.param_bytes)

    def handles(self, fn_name: str) -> bool:
        return fn_name in self._by_fn

    def resident(self, model: str) -> bool:
        return self._models[model].resident

    def fn_resident(self, fn_name: str) -> bool:
        """True when ``fn_name``'s model is resident (or the store does
        not handle it) — the router's cold-penalty probe."""
        model = self._by_fn.get(fn_name)
        return True if model is None else self._models[model].resident

    @property
    def resident_bytes(self) -> int:
        return sum(s.param_bytes for s in self._models.values() if s.resident)

    @property
    def inflight(self) -> int:
        """Outstanding touch/task_done imbalance across all models — must
        drain to zero once every invocation completes, fails, or is
        cancelled (the reliability tests' refcount invariant)."""
        return sum(s.inflight for s in self._models.values())

    # ------------------------------------------------------------------
    def touch(self, fn_name: str) -> bool:
        """A task needing ``fn_name``'s model is being submitted. Returns
        True when the weights are already resident (warm start); a miss
        commits them and returns False — the caller charges the
        profile's ``cold_setup_s``."""
        model = self._by_fn.get(fn_name)
        if model is None:
            return True
        st = self._models[model]
        st.inflight += 1
        st.touches += 1
        st.last_touch_t = self.loop.now if self.loop is not None else 0.0
        if st.resident:
            return True
        st.cold_touches += 1
        if self.capacity_bytes is not None:
            self._evict_for(st)
        st.resident = True
        if self.tracker is not None:
            self.tracker.commit(st.param_bytes)
        return self.pinned  # a pinned store never pays the cold term

    def preload(self, model: str) -> bool:
        """Seed ``model`` resident without counting a cold touch.

        Used by P2P artifact prefetch (``core.artifacts``): the weights
        arrived over a modeled transfer that was already priced, so
        residency is committed here exactly once and the next request's
        ``touch`` sees a warm hit — ``cold_setup_s`` is never charged on
        top of the transfer. Honors ``capacity_bytes`` eviction and
        starts the keep-alive idle clock so an unused prefetch is reaped
        like any idle model. Returns True when the model is resident on
        exit (idempotent; False only for an unknown model)."""
        st = self._models.get(model)
        if st is None:
            return False
        now = self.loop.now if self.loop is not None else 0.0
        st.last_touch_t = now
        if st.resident:
            return True
        if self.capacity_bytes is not None:
            self._evict_for(st)
        st.resident = True
        if self.tracker is not None:
            self.tracker.commit(st.param_bytes)
        if not self.pinned and st.inflight == 0:
            st.idle_since = now
            if self.keepalive_s > 0.0 and self.loop is not None:
                self.loop.after(
                    self.keepalive_s, lambda: self._reap(st), daemon=True
                )
        return True

    def _evict_for(self, incoming: _ModelState) -> None:
        """Make room for ``incoming`` under ``capacity_bytes`` by evicting
        resident idle models, least-recently-touched first (registration
        order breaks exact-time ties). Models with inflight tasks are
        never victims — their refcount holds the weights; if no victim
        set suffices, the commit proceeds over capacity (counted)."""
        need = incoming.param_bytes
        resident = self.resident_bytes
        if resident + need <= self.capacity_bytes:
            return
        victims = sorted(
            (name for name, st in self._models.items()
             if st is not incoming and st.resident and st.inflight == 0),
            key=lambda name: (self._models[name].last_touch_t,
                              self._reg_order[name]),
        )
        now = self.loop.now if self.loop is not None else 0.0
        for name in victims:
            if resident + need <= self.capacity_bytes:
                break
            st = self._models[name]
            self._release(st)
            resident -= st.param_bytes
            st.evictions += 1
            self.evictions += 1
            self.evicted_bytes += st.param_bytes
            self.eviction_log.append((now, name))
        if resident + need > self.capacity_bytes:
            self.over_capacity += 1

    def task_done(self, fn_name: str) -> None:
        """Balance a prior ``touch``: the task completed, failed, or was
        cancelled. When the model goes fully idle, schedule the
        keep-alive reap (a daemon event; pinned stores never release)."""
        model = self._by_fn.get(fn_name)
        if model is None:
            return
        st = self._models[model]
        st.inflight -= 1
        if st.inflight > 0 or self.pinned or not st.resident:
            return
        now = self.loop.now if self.loop is not None else 0.0
        st.idle_since = now
        if self.keepalive_s <= 0.0:
            self._release(st)
        elif self.loop is not None:
            self.loop.after(self.keepalive_s, lambda: self._reap(st), daemon=True)

    def _reap(self, st: _ModelState) -> None:
        if (
            st.resident
            and st.inflight == 0
            and not self.pinned
            and self.loop is not None
            and self.loop.now - st.idle_since >= self.keepalive_s - 1e-12
        ):
            self._release(st)

    def _release(self, st: _ModelState) -> None:
        st.resident = False
        if self.tracker is not None:
            self.tracker.release(st.param_bytes)

    # ------------------------------------------------------------ stats
    def summary(self) -> Dict[str, float]:
        touches = sum(s.touches for s in self._models.values())
        colds = sum(s.cold_touches for s in self._models.values())
        return {
            "models": len(self._models),
            "touches": touches,
            "cold_touches": colds,
            "cold_rate": colds / touches if touches else 0.0,
            "evictions": self.evictions,
            "evicted_bytes": self.evicted_bytes,
            "over_capacity": self.over_capacity,
        }
