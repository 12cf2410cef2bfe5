"""Memory contexts: bounded arenas with committed-page accounting (SS5).

A context is a contiguous virtual region sized by the user-declared
function memory requirement. Physical commitment is modeled at page
granularity exactly like demand paging: pages are committed on first
write, and the node-level ``MemoryTracker`` integrates committed bytes
over (virtual) time - the quantity Figures 1/10 plot.

``transfer_to`` moves items between contexts (the dispatcher's data
passing; a memcpy here, device-to-device copy for array payloads).
``transfer_ownership`` re-homes a context's committed pages onto a
different node's tracker — cross-node scheduling stages in-flight edge
payloads on the sender and hands the bytes to the receiver when the
modeled wire transfer completes.

Contract / determinism invariants:

  * every committed byte is released exactly once: ``free()`` is
    idempotent, and ``transfer_ownership`` after ``free()`` is a no-op
    (a failed invocation may free a staging context mid-flight);
  * trackers chain (``parent``): child commits/releases mirror upward
    as they happen, so an aggregate (cluster-wide) tracker maintains the
    exact merged step function — and therefore exact peaks — in O(1)
    per event (the streaming-aggregate invariant, pinned by
    tests/test_sim_fastpath.py);
  * page accounting is purely arithmetic on item ``nbytes``: identical
    writes yield identical committed-byte timelines run to run.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from repro_torch.core.items import Item, ItemSet, SetDict, sets_bytes
from repro_torch.core.sim import Timeline

PAGE = 4096


class MemoryTracker:
    """Node-wide committed-memory accounting over virtual time.

    Trackers chain: a ``parent`` tracker (e.g. the control plane's
    cluster-wide aggregate) observes every commit/release of its children
    as it happens, so the exact merged step function — and therefore the
    cluster peak — is maintained streaming in O(1) per event instead of
    re-merging per-node point lists after the fact."""

    __slots__ = ("loop", "committed", "timeline", "parent")

    def __init__(self, loop=None, parent: "Optional[MemoryTracker]" = None):
        self.loop = loop
        self.committed = 0
        self.timeline = Timeline()
        self.parent = parent
        self._record()

    def _record(self):
        t = self.loop.now if self.loop is not None else 0.0
        self.timeline.record(t, float(self.committed))

    def commit(self, nbytes: int):
        self.committed += nbytes
        self.timeline.record(
            self.loop.now if self.loop is not None else 0.0,
            float(self.committed),
        )
        if self.parent is not None:
            self.parent.commit(nbytes)

    def release(self, nbytes: int):
        self.committed -= nbytes
        self.timeline.record(
            self.loop.now if self.loop is not None else 0.0,
            float(self.committed),
        )
        if self.parent is not None:
            self.parent.release(nbytes)

    def attach_parent(self, parent: "MemoryTracker"):
        """Start mirroring into ``parent``, folding in anything already
        committed so the aggregate stays exact."""
        if self.parent is parent:
            return
        if self.parent is not None:
            raise ValueError("tracker already has a parent")
        self.parent = parent
        if self.committed:
            parent.commit(self.committed)


@dataclass(slots=True)
class MemoryContext:
    """One function's isolated memory region."""

    capacity: int
    tracker: Optional[MemoryTracker] = None
    committed_pages: int = 0
    inputs: SetDict = field(default_factory=dict)
    outputs: SetDict = field(default_factory=dict)
    code_bytes: int = 0
    freed: bool = False

    def _commit_for(self, nbytes: int):
        pages = (nbytes + PAGE - 1) // PAGE
        self.committed_pages += pages
        if self.tracker:
            self.tracker.commit(pages * PAGE)

    @property
    def committed_bytes(self) -> int:
        return self.committed_pages * PAGE

    def load_code(self, code: bytes) -> None:
        self.code_bytes = len(code)
        self._commit_for(len(code))

    def load_code_size(self, nbytes: int) -> None:
        """Commit code memory by size only (modeled fast path: no real
        disk read / memcpy, identical page accounting)."""
        self.code_bytes = nbytes
        self._commit_for(nbytes)

    def write_set(self, name: str, items: ItemSet, into: str = "inputs") -> None:
        store = self.inputs if into == "inputs" else self.outputs
        store.setdefault(name, []).extend(items)
        self._commit_for(sum(i.nbytes for i in items))

    def bulk_load(self, code_nbytes: int, inputs: SetDict) -> None:
        """Modeled cold start: commit the code plus every input set in
        ONE tracker record. Page accounting is identical to
        ``load_code_size`` followed by per-set ``write_set`` calls —
        pages still round per write, then sum — and collapsing the
        same-instant, all-positive commits into a single timeline point
        is observation-identical: the streaming integral terms it
        removes are exact float zeros (``v * 0.0``), and within a
        same-time run of one timeline the positive deltas are monotone,
        so per-node peaks and ``sim.merged_peak`` see the same maximum
        (pinned by tests/test_perf_identity.py)."""
        self.code_bytes = code_nbytes
        pages = (code_nbytes + PAGE - 1) // PAGE
        store = self.inputs
        for name, items in inputs.items():
            prev = store.get(name)
            if prev is None:
                store[name] = list(items)
            else:
                prev.extend(items)
            if len(items) == 1:
                nb = items[0].nbytes
            else:
                nb = sum(i.nbytes for i in items)
            pages += (nb + PAGE - 1) // PAGE
        self.committed_pages += pages
        if self.tracker:
            self.tracker.commit(pages * PAGE)

    def write_sets_bulk(self, sets: SetDict, into: str = "outputs") -> None:
        """Write several sets with one collapsed tracker record (same
        accounting-identity argument as ``bulk_load``)."""
        store = self.outputs if into == "outputs" else self.inputs
        pages = 0
        for name, items in sets.items():
            prev = store.get(name)
            if prev is None:
                store[name] = list(items)
            else:
                prev.extend(items)
            if len(items) == 1:
                nb = items[0].nbytes
            else:
                nb = sum(i.nbytes for i in items)
            pages += (nb + PAGE - 1) // PAGE
        self.committed_pages += pages
        if self.tracker:
            self.tracker.commit(pages * PAGE)

    def read_set(self, name: str, frm: str = "outputs") -> ItemSet:
        store = self.outputs if frm == "outputs" else self.inputs
        return list(store.get(name, []))

    def transfer_to(
        self, other: "MemoryContext", set_name: str, dst_set: str,
        items: Optional[ItemSet] = None,
    ) -> int:
        """Copy items (default: whole output set) into ``other``'s inputs.
        Returns bytes moved (the dispatcher charges transfer time)."""
        payload = items if items is not None else self.read_set(set_name)
        other.write_set(dst_set, payload, into="inputs")
        return sum(i.nbytes for i in payload)

    def transfer_ownership(self, tracker: Optional[MemoryTracker]) -> None:
        """Re-home this context's committed pages onto ``tracker`` (the
        receiving node): released from the current tracker, committed to
        the new one, in the same virtual instant. No-op once freed — a
        failed invocation may free a staging context while its transfer
        task is still in flight, and the bytes must not be re-committed
        (freed-exactly-once invariant)."""
        if self.freed or tracker is self.tracker:
            return
        nbytes = self.committed_bytes
        if self.tracker is not None:
            self.tracker.release(nbytes)
        self.tracker = tracker
        if self.tracker is not None and nbytes:
            self.tracker.commit(nbytes)

    def free(self) -> None:
        if self.freed:
            return
        self.freed = True
        if self.tracker:
            self.tracker.release(self.committed_bytes)
        self.inputs.clear()
        self.outputs.clear()
        self.committed_pages = 0
