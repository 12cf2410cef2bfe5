# det-lint: file waive[wall-clock] reason=real-exec cold-start measurement; wall time here IS the measurement, not a model
"""Cold-start backends: three real code paths with Table-1-style phases.

The paper's four isolation backends (CHERI/rWasm/process/KVM) are CPU
hardware mechanisms with no GPU analogue. What *does* transfer is the
cold-start cost structure, which we reproduce with real work on this
platform, over a torch payload (``ComputeFunction.torch_fn`` and its
``example_args``):

  dandelion  -- Dandelion's own path: bind a memory context + load the
                function binary from the RAM code cache (disk on a cache
                miss) + set up the I/O descriptor structure. No compile,
                no deserialize: this is the 100s-of-us path.
  snapshot   -- Firecracker-snapshot analogue: the payload is exported
                once (``torch.export.export``, saved to bytes with
                ``torch.export.save``), and every cold start loads those
                bytes (``torch.export.load`` + ``.module()``) onto the
                device. ms-scale.
  microvm    -- Firecracker full-boot analogue: a fresh ``torch.compile``
                of the payload and its first call on the critical path
                (Dynamo's trace, Inductor's lowering and code generation:
                Triton kernels on the card, C++ on the CPU), with Dynamo
                reset and Inductor's FX-graph and autotune caches off at
                every boot. 100ms-scale and up.

What a microvm boot cannot shed: Inductor keeps the code it has compiled
in the process (its Python-module and C++/Triton code caches hold loaded
modules by source hash), so a boot whose generated source is the same as
an earlier boot's re-traces, re-lowers and generates that source again,
but does not compile or load it again. The first boot of a process also
pays Inductor's own start-up (imports, worker pools): 30-40 s on a CPU
host. Report the first boot apart from the rest.

The two AOT backends run on the device they are given (``device=``,
``"cuda"`` by default): the snapshot loads onto it, microvm compiles for
it. A missing card raises, and so does a failed export, load or compile:
no backend falls back to another or to the CPU.

Phases mirror Table 1: marshal requests / load from disk / transfer input
/ execute(-setup) / get+send output. ``measure`` runs the real path k
times and returns median phase durations; the virtual-time engines then
consume these profiles (with seeded lognormal jitter) so thousand-RPS
sweeps stay faithful to measured costs. CUDA runs asynchronously, so the
card is synchronised (``sync_device``) before every clock read that
closes or opens a payload's run.

Counterpart of ``repro.core.coldstart``, where snapshot is a
``serialize_executable`` round trip and microvm a ``jax.jit`` compile.
"""
from __future__ import annotations

import contextlib
import io
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.bridge import to_numpy
from repro_torch.core.context import MemoryContext
from repro_torch.core.items import Item, SetDict
from repro_torch.core.registry import ComputeFunction, FunctionRegistry
from repro_torch.models.common import resolve_device

BACKENDS = ("dandelion", "snapshot", "microvm")

# The compile caches a microvm boot turns off, by config module: Inductor's
# FX-graph and autotune caches and AOTAutograd's cache (which would hand back
# a compiled graph); each setting applied where this torch has it
_CACHES_OFF = {
    "_inductor": {"fx_graph_cache": False, "fx_graph_remote_cache": False,
                  "autotune_local_cache": False, "autotune_remote_cache": False,
                  "bundled_autotune_remote_cache": False},
    "_functorch": {"enable_autograd_cache": False, "enable_remote_autograd_cache": False},
}


def sync_device() -> None:
    """Wait for the work queued on the card, so that the host clock read next
    sees a payload's device time, not its launch time. A no-op until CUDA is
    initialised in the process, so always on a CPU run."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@dataclass
class ColdStartBreakdown:
    """Per-phase seconds (Table 1 rows)."""

    marshal: float = 0.0
    load: float = 0.0
    transfer: float = 0.0
    execute_setup: float = 0.0
    output: float = 0.0

    @property
    def total(self) -> float:
        return self.marshal + self.load + self.transfer + self.execute_setup + self.output

    def us(self) -> Dict[str, float]:
        return {
            "marshal_us": self.marshal * 1e6,
            "load_us": self.load * 1e6,
            "transfer_us": self.transfer * 1e6,
            "execute_setup_us": self.execute_setup * 1e6,
            "output_us": self.output * 1e6,
            "total_us": self.total * 1e6,
        }


class _Payload(torch.nn.Module):
    """``torch_fn`` as a module (``torch.export`` takes modules only); a
    payload that is a module is held as a submodule, so its parameters are
    part of the exported program."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _example_args(cf: ComputeFunction, device: torch.device) -> Tuple[torch.Tensor, ...]:
    if cf.torch_fn is None:
        raise ValueError(f"{cf.name}: the snapshot and microvm backends need a torch payload")
    return tuple(a.to(device) for a in cf.example_args)


class _AotCache:
    """Exported-program store for the snapshot backend: the bytes of
    ``torch.export.save``, one per (function, device)."""

    def __init__(self):
        self._snapshots: Dict[Tuple[str, str], bytes] = {}

    def snapshot_blob(self, cf: ComputeFunction, device: torch.device) -> bytes:
        key = (cf.name, str(device))
        if key in self._snapshots:
            return self._snapshots[key]
        program = torch.export.export(_Payload(cf.torch_fn), _example_args(cf, device))
        buf = io.BytesIO()
        torch.export.save(program, buf)
        self._snapshots[key] = buf.getvalue()
        return self._snapshots[key]


_AOT = _AotCache()


def _boot(cf: ComputeFunction, device: torch.device) -> Callable:
    """A microvm boot: Dynamo reset, then a fresh wrapper compiled whole for
    ``device`` with Inductor's persistent caches off, and its first call on
    the example arguments (which is when Dynamo traces and Inductor compiles)."""
    args = _example_args(cf, device)
    torch._dynamo.reset()
    with contextlib.ExitStack() as stack:
        for mod, settings in _CACHES_OFF.items():
            config = getattr(torch, mod).config
            stack.enter_context(config.patch({k: v for k, v in settings.items()
                                              if hasattr(config, k)}))
        compiled = torch.compile(_Payload(cf.torch_fn), fullgraph=True, dynamic=False)
        with torch.inference_mode():
            compiled(*args)
    return compiled


def _marshal(inputs: SetDict) -> Dict[str, Any]:
    """Build the low-level descriptor structure the function sees (SS4.1)."""
    return {
        name: [(it.key, it.nbytes) for it in items]
        for name, items in inputs.items()
    }


def cold_start(
    registry: FunctionRegistry,
    name: str,
    inputs: SetDict,
    *,
    backend: str = "dandelion",
    cached: bool = True,
    tracker=None,
    modeled: bool = False,
    device="cuda",
) -> Tuple[MemoryContext, ColdStartBreakdown, Callable[[], SetDict]]:
    """Run the real cold-start path. Returns (context, phases, run_fn).

    ``run_fn()`` executes the function body against the prepared context
    and writes outputs back into it (timed separately by the caller).
    ``device`` is where the snapshot and microvm backends run the payload;
    the dandelion backend runs ``cf.fn``, which places its own work.

    ``modeled=True`` is the simulator fast path for tasks whose durations
    come from a calibrated ``ColdStartProfile``: the phase breakdown is
    not consumed, so the real disk read / export load / compile work
    is skipped (memory is committed by size, page-identical), and the
    payload executes through the registry's content-addressed memo —
    each distinct ``(fn, input digest)`` body runs once, repeated trace
    events reuse the outputs. Dataflow and committed-memory accounting
    stay byte-identical with the measured path.
    """
    cf = registry.get(name)
    bd = ColdStartBreakdown()

    if modeled:
        ctx = MemoryContext(capacity=cf.context_bytes, tracker=tracker)
        # code + input-set pages commit as one collapsed tracker record
        # (accounting-identical; see MemoryContext.bulk_load)
        ctx.bulk_load(len(cf.code), inputs)
        memo = registry.memo

        def run_modeled() -> SetDict:
            out = memo.run(cf, ctx.inputs) if memo is not None else cf.fn(ctx.inputs)
            ctx.write_sets_bulk(out, into="outputs")
            return out

        return ctx, bd, run_modeled

    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; known {BACKENDS}")
    dev = resolve_device(device) if backend != "dandelion" else None

    t0 = time.perf_counter()
    desc = _marshal(inputs)
    bd.marshal = time.perf_counter() - t0

    t0 = time.perf_counter()
    code = registry.load_code(name, cached=cached)
    bd.load = time.perf_counter() - t0

    t0 = time.perf_counter()
    ctx = MemoryContext(capacity=cf.context_bytes, tracker=tracker)
    ctx.load_code(code)
    for set_name, items in inputs.items():
        ctx.write_set(set_name, items)
    bd.transfer = time.perf_counter() - t0

    t0 = time.perf_counter()
    runner: Callable[[], SetDict]
    if backend == "dandelion":
        fn = cf.fn
        runner = lambda: fn(ctx.inputs)
    else:
        if backend == "snapshot":
            blob = _AOT.snapshot_blob(cf, dev)
            program = torch.export.load(io.BytesIO(blob)).module()
        else:  # microvm
            program = _boot(cf, dev)
        runner = _torch_runner(cf, program, ctx, dev)
        sync_device()  # the load's copies and the boot's first call are device work
    bd.execute_setup = time.perf_counter() - t0

    def run_and_collect() -> SetDict:
        out = runner()
        sync_device()
        t1 = time.perf_counter()
        for sname, items in out.items():
            ctx.write_set(sname, items, into="outputs")
        bd.output = time.perf_counter() - t1
        return out

    return ctx, bd, run_and_collect


def _torch_runner(cf: ComputeFunction, program: Callable, ctx: MemoryContext,
                  device: torch.device):
    """Adapt an exported or compiled torch payload to the SetDict interface:
    the array inputs of the sets, in order, as many as ``example_args`` has,
    become tensors on ``device`` in the dtypes of ``example_args``; the
    outputs come back as host numpy arrays (the copy waits for the card)."""

    def run() -> SetDict:
        arrays = []
        for items in ctx.inputs.values():
            for it in items:
                if hasattr(it.data, "shape"):
                    arrays.append(it.data)
        args = [torch.as_tensor(a).to(device=device, dtype=ex.dtype)
                for a, ex in zip(arrays, cf.example_args)]
        with torch.inference_mode():
            result = program(*args)
        leaves = result if isinstance(result, (tuple, list)) else [result]
        return {"out": [Item(to_numpy(x)) for x in leaves]}

    return run


def measure(
    registry: FunctionRegistry,
    name: str,
    inputs: SetDict,
    *,
    backend: str = "dandelion",
    cached: bool = True,
    samples: int = 7,
    execute: bool = True,
    device="cuda",
) -> Tuple[ColdStartBreakdown, float]:
    """Median phase breakdown over ``samples`` real runs.

    Returns (breakdown, execute_seconds). Set ``execute=False`` to measure
    only sandbox creation (Fig. 5's workload). ``device`` as in
    ``cold_start``.
    """
    phases = []
    exec_times = []
    for _ in range(samples):
        ctx, bd, run = cold_start(
            registry, name, inputs, backend=backend, cached=cached, device=device
        )
        if execute:
            sync_device()
            t0 = time.perf_counter()
            run()
            exec_times.append(time.perf_counter() - t0 - bd.output)
        phases.append(bd)
        ctx.free()
    med = lambda xs: float(np.median(xs))
    out = ColdStartBreakdown(
        marshal=med([p.marshal for p in phases]),
        load=med([p.load for p in phases]),
        transfer=med([p.transfer for p in phases]),
        execute_setup=med([p.execute_setup for p in phases]),
        output=med([p.output for p in phases]),
    )
    return out, (med(exec_times) if exec_times else 0.0)


class CodeCache:
    """Per-node RAM code-cache residency model (SS5 two-level code store).

    The ``FunctionRegistry`` owns the *global* disk/RAM store; this class
    models which function binaries are resident in ONE worker node's RAM,
    which is what locality-aware routing cares about: a request lands
    "warm" only on a node that has already loaded the composition's
    functions. LRU over a bounded number of entries, with hit/miss
    counters the control plane exports through ``tracing.RoutingStats``.
    """

    def __init__(self, capacity_entries: int = 256):
        if capacity_entries <= 0:
            raise ValueError("code cache needs capacity >= 1 entry")
        self.capacity_entries = capacity_entries
        self._lru: "OrderedDict[str, None]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def resident(self, fn_name: str) -> bool:
        return fn_name in self._lru

    def warm_fraction(self, fn_names) -> float:
        """Fraction of ``fn_names`` resident — the routing affinity score."""
        names = list(fn_names)
        if not names:
            return 0.0
        return sum(1 for n in names if n in self._lru) / len(names)

    def warm(self, fn_name: str) -> None:
        """Seed residency without counting a hit or a miss.

        Used by P2P artifact prefetch (``core.artifacts``): the binary
        arrived over a modeled transfer, not a disk load, so the next
        ``touch`` must be a warm hit and hit/miss rates must reflect only
        real request traffic.
        """
        already = fn_name in self._lru
        self._lru[fn_name] = None
        self._lru.move_to_end(fn_name)
        if not already:
            while len(self._lru) > self.capacity_entries:
                self._lru.popitem(last=False)
                self.evictions += 1

    def touch(self, fn_name: str) -> bool:
        """Record a code load; returns True on a RAM hit (no disk read)."""
        hit = fn_name in self._lru
        if hit:
            self._lru.move_to_end(fn_name)
            self.hits += 1
        else:
            self.misses += 1
            self._lru[fn_name] = None
            while len(self._lru) > self.capacity_entries:
                self._lru.popitem(last=False)
                self.evictions += 1
        return hit

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def __len__(self) -> int:
        return len(self._lru)


@dataclass
class ColdStartProfile:
    """Calibrated per-(function, backend) profile consumed by the
    virtual-time engines: deterministic base + seeded lognormal jitter.

    ``cold_setup_s`` is the extra, deliberately jitter-free setup charged
    when the task runs without resident state (``Task.cold_setup`` set by
    the dispatcher: a weight-store miss, or — for functions no store
    handles — a code-residency miss): for ordinary functions a disk code
    load, for serving functions the model-weight load + compile term
    (the reference prices it from its HLO cost models). Zero by
    default, so existing profiles and their RNG draw order are untouched
    (the byte-identity contract)."""

    setup_s: float            # marshal+load+transfer+execute_setup+output
    execute_s: float
    jitter_sigma: float = 0.08
    cold_setup_s: float = 0.0  # added when the task is not cached/resident

    def sample(self, rng: np.random.Generator) -> Tuple[float, float]:
        j1 = float(rng.lognormal(0.0, self.jitter_sigma))
        j2 = float(rng.lognormal(0.0, self.jitter_sigma))
        return self.setup_s * j1, self.execute_s * j2


@dataclass(frozen=True)
class TransferProfile:
    """Deterministic per-link model for cross-node data movement.

    When a composition vertex is placed on a different node than one of
    its producers (cross-node scheduling, ``cluster.CrossNodePlacer``),
    the producing node's comm engine is charged one transfer task per
    crossing edge. ``charge(nbytes)`` splits the cost into

      * ``cpu_s`` — protocol/copy CPU that occupies the sender's comm
        slot (cooperative, like HTTP protocol handling);
      * ``io_s`` — wire time (link latency + bytes/bandwidth) during
        which the slot is free for other green tasks.

    Deliberately jitter-free: given the same placements and payload
    bytes, transfer durations are byte-stable run to run (the same
    determinism contract as the modeled comm-protocol CPU)."""

    latency_s: float = 100e-6       # per-message link latency
    bandwidth_bps: float = 1.25e9   # wire rate in bytes/sec (~10 GbE)
    cpu_per_byte_s: float = 1e-10   # sender-side protocol/copy CPU
    min_cpu_s: float = 2e-6         # floor, matches http.MIN_COMM_CPU_S

    def charge(self, nbytes: int) -> Tuple[float, float]:
        """(cpu_s, io_s) for moving ``nbytes`` over this link."""
        cpu_s = self.min_cpu_s + nbytes * self.cpu_per_byte_s
        io_s = self.latency_s + nbytes / self.bandwidth_bps
        return cpu_s, io_s


def profile_from_measurement(
    registry: FunctionRegistry,
    name: str,
    inputs: SetDict,
    backend: str = "dandelion",
    cached: bool = True,
) -> ColdStartProfile:
    bd, exec_s = measure(registry, name, inputs, backend=backend, cached=cached)
    return ColdStartProfile(setup_s=bd.total, execute_s=exec_s)
