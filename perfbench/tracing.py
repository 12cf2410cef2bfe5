"""What a traced run records, and the reduction of it.

``KernelCalls`` wraps the program's kernel entry points (``repro_torch.kernels.ops``)
and its backward kernels (each kernel module's ``backward``, ``plain_backward`` on
the CPU) while it is installed, and keeps each call's sizes and the counts that
depend on its inputs (a decode call's allowed (row, slot) pairs, a ``moe_gmm``
call's live rows and the experts that have one) as device scalars, read once the
traced window has closed. ``DeviceTrace`` is the profiler's raw events of the traced
window (kernels on the card, ops on the host), kept in memory: no trace file is
written.

Besides the seven kernels built in here, a kernel is counted by a file of its own,
``perfbench/kernels/<kernel>.py``, which gives:

* ``SYMBOLS``: substrings of its device kernels' names;
* ``WRAP``: the program's entry points to wrap, as (module, attribute) pairs;
* ``record(*args, **kwargs) -> (sizes, counts)``: of a call's arguments, the sizes its
  cost takes and the device scalars its inputs give (or None);
* ``cost(sizes, counts) -> costs.Cost``: the call's work, ``counts`` read back as a list
  (or None), with the type of its operands (``Cost.op_type``), whose peak bounds it.

The built-in kernels come first, then the files in name order; a file whose symbols
overlap (one holds the other) a built-in kernel's or an earlier file's fails when it
is loaded, and a device kernel whose name holds a file's symbol and another kernel's
fails when it is matched.
"""
from __future__ import annotations

import contextlib
import functools
import importlib
import importlib.util
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

from perfbench import costs, stats

KERNELS_DIR = Path(__file__).resolve().parent / "kernels"   # the kernel files, read at each use

# kernel -> substrings of its device kernels' names (the first kernel whose substring
# a name holds takes it; the backward kernels first)
KERNEL_SYMBOLS = (("rmsnorm_backward", ("rmsnorm_bwd_",)),
                  ("flash_attention_backward", ("flash_bwd_",)),
                  ("moe_gmm_backward", ("gmm_bwd_",)),
                  ("rmsnorm", ("rmsnorm_kernel",)),
                  ("flash_attention", ("flash_kernel", "flash_fwd_")),
                  ("decode_attention", ("decode_kernel",)),
                  ("moe_gmm", ("gmm_wgmma_kernel", "gmm_f32_kernel")))


@dataclass(frozen=True)
class KernelFile:
    """A kernel counted by its file (``perfbench/kernels/<name>.py``)."""
    name: str
    symbols: Tuple[str, ...]
    wrap: Tuple[Tuple[str, str], ...]
    record: Callable
    cost: Callable


def kernel_files() -> Tuple[KernelFile, ...]:
    """The kernels of the files in ``KERNELS_DIR``, in name order."""
    return _load(Path(KERNELS_DIR))


@functools.lru_cache(maxsize=None)
def _load(kernels_dir: Path) -> Tuple[KernelFile, ...]:
    taken = [(k, s) for k, keys in KERNEL_SYMBOLS for s in keys]
    out = []
    for path in sorted(kernels_dir.glob("[!_]*.py")):
        spec = importlib.util.spec_from_file_location(f"perfbench_kernel_{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        kf = KernelFile(path.stem, tuple(mod.SYMBOLS), tuple(tuple(w) for w in mod.WRAP),
                        mod.record, mod.cost)
        for s in kf.symbols:
            clash = [(k, t) for k, t in taken if s in t or t in s]
            if clash:
                raise ValueError(f"{path}: symbol {s!r} overlaps {clash[0][0]}'s {clash[0][1]!r}")
            taken.append((kf.name, s))
        out.append(kf)
    return tuple(out)


def kernel_of(symbol: str) -> Optional[str]:
    """The kernel a device kernel's name belongs to: a built-in one's, then a file's. A
    name that holds a file's symbol and another kernel's fails, naming both."""
    builtin = next((k for k, keys in KERNEL_SYMBOLS if any(s in symbol for s in keys)), None)
    files = [f.name for f in kernel_files() if any(s in symbol for s in f.symbols)]
    if files and (builtin is not None or len(files) > 1):
        raise ValueError(f"device kernel {symbol!r} matches the kernels "
                         f"{([builtin] if builtin else []) + files}")
    return builtin if builtin is not None else next(iter(files), None)


@dataclass
class Call:
    kernel: str
    sizes: tuple                       # the cost function's shape arguments
    counts: Optional[torch.Tensor]     # device scalars the inputs give (or None)


class KernelCalls:
    """Records every kernel call between ``install`` and ``remove``: the built-in
    kernels', then those of the kernel files."""

    def __init__(self) -> None:
        self.calls: List[Call] = []
        self._saved: List[Tuple[object, str, object]] = []
        self.files = {f.name: f for f in kernel_files()}

    def _patch(self, owner, name: str, wrapper) -> None:
        self._saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, wrapper)

    def install(self) -> None:
        from repro_torch.kernels import flash_attention as fl
        from repro_torch.kernels import moe_gmm as gmm
        from repro_torch.kernels import ops
        from repro_torch.kernels import rmsnorm as rms
        calls = self.calls

        def wrap(owner, name, record):
            inner = getattr(owner, name)

            def wrapper(*args, **kwargs):
                calls.append(record(*args, **kwargs))
                return inner(*args, **kwargs)
            self._patch(owner, name, wrapper)

        def rms_call(kernel):
            return lambda x, scale, *a, **k: Call(kernel, (x.numel(), x.shape[-1],
                                                           x.element_size()), None)

        def flash_call(kernel):
            def rec(q, k, v, *a, causal=True, window=0, **kw):
                b, sq, hq, dh = q.shape
                return Call(kernel, (b, sq, k.shape[1], hq, k.shape[2], dh, q.element_size(),
                                     bool(causal), int(window)), None)
            return rec

        def gmm_call(kernel):
            def rec(xe, we, live=None, *a, **kw):
                e, r, d = xe.shape
                if live is None:
                    counts = None
                else:
                    per = live.sum(dim=1)
                    counts = torch.stack([per.sum(), (per > 0).sum()])
                return Call(kernel, (e, r, d, we.shape[2], xe.element_size()), counts)
            return rec

        def decode_rec(q, kc, vc, sp, pos, *a, window=0, **kw):
            ok = (sp >= 0) & (sp <= pos[:, None])
            if window:
                ok &= pos[:, None] - sp < window
            counts = torch.stack([ok.sum(), (~ok.any(dim=1)).sum()])
            b, hq, dh = q.shape
            return Call("decode_attention", (b, kc.shape[1], hq, kc.shape[2], dh, q.element_size(),
                                             kc.element_size()), counts)

        wrap(ops, "rmsnorm", rms_call("rmsnorm"))
        wrap(ops, "flash_attention", flash_call("flash_attention"))
        wrap(ops, "decode_attention", decode_rec)
        wrap(ops, "moe_gmm", gmm_call("moe_gmm"))
        for name in ("backward", "plain_backward"):
            wrap(rms, name, rms_call("rmsnorm_backward"))
            wrap(fl, name, flash_call("flash_attention_backward"))
            wrap(gmm, name, gmm_call("moe_gmm_backward"))

        def file_call(kf):
            return lambda *a, **k: Call(kf.name, *kf.record(*a, **k))
        for kf in self.files.values():
            for module, name in kf.wrap:
                wrap(importlib.import_module(module), name, file_call(kf))

    def remove(self) -> None:
        while self._saved:
            owner, name, fn = self._saved.pop()
            setattr(owner, name, fn)

    def costs(self) -> Dict[str, List[costs.Cost]]:
        """Each kernel's calls' costs, the device counts read in one copy."""
        with_counts = [c for c in self.calls if c.counts is not None]
        flat = (torch.cat([c.counts.reshape(-1) for c in with_counts]).tolist() if with_counts
                else [])
        read, at = {}, 0
        for c in with_counts:
            read[id(c)] = flat[at:at + c.counts.numel()]
            at += c.counts.numel()
        out: Dict[str, List[costs.Cost]] = {}
        for c in self.calls:
            n = read.get(id(c))
            if c.kernel in self.files:
                cost = self.files[c.kernel].cost(c.sizes, n)
            elif c.kernel in ("rmsnorm", "rmsnorm_backward", "flash_attention",
                            "flash_attention_backward"):
                cost = getattr(costs, c.kernel)(*c.sizes)
            elif c.kernel == "decode_attention":
                cost = costs.decode_attention(*c.sizes, valid=int(n[0]), rows_without=int(n[1]))
            else:
                e, r = c.sizes[0], c.sizes[1]
                rows, experts = (e * r, e) if n is None else (int(n[0]), int(n[1]))
                cost = getattr(costs, c.kernel)(*c.sizes, rows=rows, experts=experts)
            out.setdefault(c.kernel, []).append(cost)
        return out


@dataclass
class DeviceTrace:
    """The traced window [start_ns, end_ns] on the profiler's clock; device kernels
    (name, start_ns, end_ns); host ops (name, start_ns, end_ns)."""
    start_ns: int
    end_ns: int
    kernels: List[Tuple[str, int, int]] = field(default_factory=list)
    host: List[Tuple[str, int, int]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def busy_s(self) -> float:
        return stats.union_length(((s, e) for _, s, e in self.kernels),
                                  self.start_ns, self.end_ns) / 1e9

    def kernel_seconds(self) -> Dict[str, float]:
        """Device seconds by kernel of the program (``KERNEL_SYMBOLS``, then the kernel
        files')."""
        of = {name: kernel_of(name) for name in {n for n, _, _ in self.kernels}}
        out: Dict[str, float] = {}
        for name, s, e in self.kernels:
            k = of[name]
            if k is not None:
                out[k] = out.get(k, 0.0) + (e - s) / 1e9
        return out

    def device_ops(self, top: int = 10) -> List[list]:
        """The device operations that took most time, by name (cut to 120 letters)."""
        by: Dict[str, float] = {}
        for name, s, e in self.kernels:
            by[name] = by.get(name, 0.0) + (e - s) / 1e9
        return [[n[:120], v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """The longest idle stretches of the device, each named by the innermost host
        op running at its middle ("host idle" where none was)."""
        idle = stats.gaps([(s, e) for _, s, e in self.kernels], self.start_ns, self.end_ns)
        idle = sorted(idle, key=lambda g: g[0] - g[1])[:top]
        host = sorted(self.host, key=lambda h: h[1])
        out = []
        for s, e in idle:
            mid = (s + e) // 2
            inner = [h for h in host if h[1] <= mid <= h[2]]
            name = min(inner, key=lambda h: h[2] - h[1])[0] if inner else "host idle"
            out.append([name, (e - s) / 1e9])
        return out


@contextlib.contextmanager
def profiled(out: list):
    """Profile the block on the card (kernels and host ops); appends a ``DeviceTrace``
    of it to ``out`` when the block ends."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    with profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])) as prof:
        with record_function("perfbench.traced_window"):
            yield
            if cuda:
                torch.cuda.synchronize()
    tr = None
    kernels, host = [], []
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if ev.name() == "perfbench.traced_window":   # on the host, and its mark on the device
            if ev.device_type() != DeviceType.CUDA:
                tr = (s, e)
        elif ev.device_type() == DeviceType.CUDA:
            kernels.append((ev.name(), s, e))
        else:
            host.append((ev.name(), s, e))
    if tr is None:
        raise RuntimeError("the profiler recorded no traced window")
    out.append(DeviceTrace(tr[0], tr[1], kernels, host))


def profiled_warm() -> None:
    """One short profile, so that the profiler's own start-up (CUPTI) is set-up and not
    part of the traced window."""
    with profiled([]):
        torch.zeros(1, device="cuda" if torch.cuda.is_available() else "cpu").add_(1)
