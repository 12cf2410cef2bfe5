"""Finding a cell's parts by name, and the run's result.

A cell ``<cell>`` is ``perfbench/workloads/<cell>.json`` (its traffic, its checks'
limits and its ``runner``), its configuration ``perfbench/configs/<config>.json``,
and the metrics ``BENCHMARK.json`` lists for it. A configuration names its reference
module (``"reference"``, found by ``perfbench.reference.for_config``) and may set the
program's fields (``"program"``, applied by ``perfbench.program.model_config``); a
kernel is counted by a file ``perfbench/kernels/<kernel>.py`` (``perfbench.tracing``).
A per-layer metric is read by ``perfbench/metrics/<m>.py``, the first of these that
exists for the metric ``m``: the whole name, then its dotted prefixes from the longest
(``mfu.serve`` -> ``mfu``). A reader has ``read(name, record) -> float | None`` and
returns None where it finds nothing.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # top-level module names, compared whole


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(root: Path, workload: str) -> Tuple[dict, dict]:
    cell = load_json(root / "perfbench" / "workloads" / f"{workload}.json")
    config = load_json(root / "perfbench" / "configs" / f"{cell['config']}.json")
    return cell, config


def metrics_for(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics ``BENCHMARK.json`` has a cell report: end-to-end without the trace,
    per-layer with it; a metric without ``workloads`` is every cell's."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def reader_for(name: str, metrics_dir: Path = HERE / "metrics") -> Optional[Callable]:
    parts = name.split(".")
    for c in (".".join(parts[:i]) for i in range(len(parts), 0, -1)):
        path = metrics_dir / f"{c}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(f"perfbench_metric_{c}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    return None


@dataclass
class Check:
    """One number compared: ``value`` must not exceed ``limit``."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Record:
    """What a run gives the per-layer readers.

    ``spans``: name -> [(start, end)] host seconds, timed from the benchmark's side
    in the untraced part of a traced run's window; ``counters``: name -> number or
    list; ``kernel_costs``: kernel -> each call's ``costs.Cost`` in the traced
    window; ``device``: that window's ``trace.DeviceTrace``."""
    cell: dict
    config: dict
    spans: Dict[str, List[Tuple[float, float]]] = field(default_factory=dict)
    span_window: Tuple[float, float] = (0.0, 0.0)
    counters: Dict[str, object] = field(default_factory=dict)
    kernel_costs: Dict[str, list] = field(default_factory=dict)
    device: object = None


@dataclass
class Outcome:
    """A runner's result: the end-to-end metrics it measured, the run's record, the
    checks, the requests or steps attempted and failed, the peak device bytes."""
    end_to_end: Dict[str, float]
    record: Record
    checks: List[Check]
    attempted: int
    failed: int
    memory_peak_bytes: int
    served: Optional[list] = None      # a served cell's compared (prompt, tokens)


def process_start() -> float:
    """This process's start on the ``time.perf_counter`` clock (10 ms resolution)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    age = time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")
    return time.perf_counter() - age


def forbidden_modules(names=None) -> List[str]:
    """The forbidden top-level names among ``names`` (the loaded modules by default)."""
    names = list(sys.modules) if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def result_line(outcome: Outcome, metrics: List[dict], trace: bool, device: dict) -> Tuple[dict, List[str]]:
    """The result's JSON object and the lines of checks for standard error. A metric
    the cell lists that reads nothing, or (traced) a kernel called with no device time
    matched to it, fails the run."""
    values: Dict[str, dict] = {}
    missing = []
    for m in metrics:
        if trace:
            read = reader_for(m["name"])
            v = None if read is None else read(m["name"], outcome.record)
        else:
            v = outcome.end_to_end.get(m["name"])
        if v is None:
            missing.append(m["name"])
            continue
        values[m["name"]] = {"value": v, "unit": m["unit"]}
    if missing:
        raise RuntimeError(f"{'per-layer' if trace else 'end-to-end'} metrics of this cell read "
                           f"nothing: {missing}")
    tr = outcome.record.device
    if trace and tr is not None:
        seconds = tr.kernel_seconds()
        unmatched = sorted(k for k, calls in outcome.record.kernel_costs.items()
                           if calls and seconds.get(k, 0.0) <= 0.0)
        if unmatched:
            raise RuntimeError(f"kernels called in the traced window with no device time "
                               f"matched to them: {unmatched}")
    correct = all(c.ok for c in outcome.checks) and outcome.failed == 0
    line = {"correct": correct, "attempted": outcome.attempted, "failed": outcome.failed,
            "metrics": values, "device": device}
    if trace and tr is not None:
        line["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in outcome.checks}
    return line, check_lines(outcome.checks)


def check_lines(checks: List[Check]) -> List[str]:
    return [f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}"
            for c in checks]
