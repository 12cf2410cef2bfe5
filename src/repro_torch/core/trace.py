"""Synthetic Azure-Functions-like trace generator.

The real Azure trace is not shipped in this offline container, so we
generate a statistically matched workload following the published
characterization (Shahrad et al., ATC'20 [93]):

  * per-function invocation rates are heavy-tailed (Zipf-like: a few hot
    functions dominate, a long tail is called rarely);
  * execution times are lognormal, median tens of ms;
  * arrivals are bursty: per-function ON/OFF modulation over Poisson
    arrivals;
  * memory requirements: lognormal around ~100-300 MB.

Deterministic given the seed: the same arrays as ``repro.core.trace``
for the same arguments.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np


@dataclass(frozen=True)
class TraceFunction:
    name: str
    rate_hz: float            # average invocation rate
    exec_median_s: float
    exec_sigma: float
    context_bytes: int
    burst_period_s: float     # ON/OFF cycle length
    burst_duty: float         # fraction of the period that is ON
    burst_phase: float = 0.0  # period fraction offsetting the ON window


@dataclass
class TraceEvent:
    t: float
    fn: str
    exec_s: float


def generate_functions(
    n_functions: int = 100,
    *,
    seed: int = 0,
    total_rate_hz: float = 50.0,
    zipf_s: float = 1.2,
    burst_period_range: Tuple[float, float] = (20.0, 120.0),
    burst_duty_range: Tuple[float, float] = (0.2, 0.9),
    exec_median_s: float = 0.030,
    stagger_bursts: bool = False,
) -> List[TraceFunction]:
    """``burst_duty_range`` shapes elasticity experiments: low duty means
    sharp ON/OFF bursts (Fig.-11-style scale-out), the default wide range
    reproduces the mixed Azure characterization. ``stagger_bursts`` gives
    each function a random ON-window phase so bursts are not synchronized
    at t=0 (defaults off to keep existing experiments bit-stable)."""
    rng = np.random.default_rng(seed)
    weights = 1.0 / np.arange(1, n_functions + 1) ** zipf_s
    weights /= weights.sum()
    rng.shuffle(weights)
    fns = []
    for i in range(n_functions):
        med = float(np.exp(rng.normal(np.log(exec_median_s), 0.8)))
        med = min(max(med, 0.002), 2.0)
        mem = int(np.exp(rng.normal(np.log(150e6), 0.5)))
        mem = min(max(mem, 16 << 20), 1 << 30)
        fns.append(
            TraceFunction(
                name=f"fn{i:03d}",
                rate_hz=float(total_rate_hz * weights[i]),
                exec_median_s=med,
                exec_sigma=0.4,
                context_bytes=mem,
                burst_period_s=float(rng.uniform(*burst_period_range)),
                burst_duty=float(rng.uniform(*burst_duty_range)),
                burst_phase=float(rng.uniform()) if stagger_bursts else 0.0,
            )
        )
    return fns


def generate_events(
    fns: List[TraceFunction],
    duration_s: float,
    *,
    seed: int = 1,
) -> List[TraceEvent]:
    """ON/OFF-modulated Poisson arrivals, vectorized by thinning:
    a homogeneous stream at the ON-phase rate is generated for the whole
    window and arrivals falling in OFF phases are dropped - statistically
    identical to drawing only during ON windows, with no scalar loops."""
    rng = np.random.default_rng(seed)
    events: List[TraceEvent] = []
    for f in fns:
        on_rate = f.rate_hz / max(f.burst_duty, 1e-3)
        n = int(min(on_rate * duration_s * 1.5 + 50, 5_000_000))
        ts = np.cumsum(rng.exponential(1.0 / max(on_rate, 1e-9), size=n))
        phase = (ts / f.burst_period_s + f.burst_phase) % 1.0
        ts = ts[(phase < f.burst_duty) & (ts < duration_s)]
        exec_s = np.exp(
            rng.normal(np.log(f.exec_median_s), f.exec_sigma, size=ts.size)
        )
        events.extend(
            TraceEvent(float(t), f.name, float(e)) for t, e in zip(ts, exec_s)
        )
    events.sort(key=lambda e: e.t)
    return events


def replay(loop, events: List[TraceEvent], fn) -> None:
    """Inject a sorted trace through a single arrival cursor: one heap
    entry outstanding at a time instead of one per future event, so
    full-scale traces cost O(1) heap residency (EventLoop.at_stream)."""
    loop.at_stream(((e.t, e) for e in events), fn)
