"""Percentiles and window arithmetic over every request or step of a run."""
from __future__ import annotations

import math
from typing import Iterable, List, Optional, Sequence, Tuple


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The q-th percentile (0-100) by linear interpolation between closest ranks
    (numpy's default); None for no values."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def ttfts(due: Sequence[float], first: Sequence[Optional[float]], open_t: float,
          close_t: float) -> List[float]:
    """Time to first token of every request due in [open_t, close_t): from its due time
    to its first token; one with no first token by the close counts its wait so far."""
    out = []
    for d, f in zip(due, first):
        if not open_t <= d < close_t:
            continue
        out.append((f if f is not None and f <= close_t else close_t) - d)
    return out


def tpots(token_times: Iterable[Sequence[float]], open_t: float, close_t: float) -> List[float]:
    """Per request with two or more tokens in the window: the time from its first to its
    last token there, over its tokens after the first."""
    out = []
    for times in token_times:
        inside = [t for t in times if open_t <= t <= close_t]
        if len(inside) >= 2:
            out.append((inside[-1] - inside[0]) / (len(inside) - 1))
    return out


def tokens_in(token_times: Iterable[Sequence[float]], open_t: float, close_t: float) -> int:
    return sum(1 for times in token_times for t in times if open_t <= t <= close_t)


def rate_over_steps(steps: Sequence[Tuple[float, float]], per_step: float) -> Optional[float]:
    """Work per second over whole steps (start, end) run back to back: all their work
    over all their time, from the first start to the last end."""
    if not steps:
        return None
    return per_step * len(steps) / (steps[-1][1] - steps[0][0])


def union_length(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> float:
    """Length of the union of [start, end) intervals, clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The idle stretches of [lo, hi] that no interval covers, in order."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]
