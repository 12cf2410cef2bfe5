"""The one generator of every traffic mix: it reads a cell's parameters (its
``perfbench/workloads/<cell>.json``) and the run's seed.

The sizes and the gaps between arrivals come from a fixed pool drawn from the mix's
own ``pool_seed``. The arrivals keep the pool's order, so every seed sends the same
schedule; the run's seed orders the sizes and draws the token ids. So every seed
gives a run the same work, and two seeds differ no more than two runs of one seed
would for a reason of the traffic: in an open loop the order of the gaps alone sets
where the bursts fall, and so the tails.

* ``lengths``: a lognormal (median, sigma) clipped to [min, max], whole tokens.
* ``open_loop``: Poisson arrivals at ``rate_per_s``: the lead-in's requests, then
  exactly ``round(rate · seconds)`` due in the window, their exponential gaps (in the
  pool's order) scaled to fill it.
* ``closed_loop``: a pool of request sizes, cycled in the seed's order by
  ``clients`` clients that each send the next request when the last one ends; the
  first request of client i keeps a share (i + 1) / clients of its output, so the
  first cohort does not finish together.
* ``train_batches``: a fresh batch of token rows a step, drawn on the device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch


def seed_rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator of the run's seed (any integer) for one purpose ``stream``."""
    return np.random.default_rng([seed % (2 ** 64), stream])


def lengths(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    x = rng.lognormal(np.log(spec["median"]), spec["sigma"], size=n)
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


@dataclass
class Planned:
    rid: int
    due: float          # seconds from the window's opening (negative: the lead-in)
    prompt_len: int
    output_len: int


def _pool(cell: dict, n: int, stream: int, run_seed: int):
    """n (prompt, output) sizes from the mix's pool, in the run seed's order."""
    base = np.random.default_rng([cell["pool_seed"], stream])
    p, o = lengths(cell["prompt_tokens"], n, base), lengths(cell["output_tokens"], n, base)
    order = seed_rng(run_seed, stream).permutation(n)
    return p[order], o[order]


def open_loop(cell: dict, seed: int, seconds: float) -> List[Planned]:
    rate, lead = cell["arrivals"]["rate_per_s"], cell["arrivals"]["lead_in_s"]
    out: List[Planned] = []
    for stream, (start, span) in enumerate(((-lead, lead), (0.0, seconds))):
        n = max(1, int(round(rate * span)))
        base = np.random.default_rng([cell["pool_seed"], 10 + stream])
        gaps = base.exponential(1.0, size=n)
        due = start + span * (np.cumsum(gaps) - gaps[0]) / gaps.sum()
        p, o = _pool(cell, n, stream, seed)
        out += [Planned(len(out) + i, float(due[i]), int(p[i]), int(o[i])) for i in range(n)]
    return out


def closed_loop(cell: dict, seed: int) -> List[Planned]:
    """The pool in the seed's order; the first ``clients`` have staggered outputs."""
    n, clients = cell["arrivals"]["pool"], cell["arrivals"]["clients"]
    p, o = _pool(cell, n, 0, seed)
    out = []
    for i in range(n):
        keep = (i + 1) / clients if i < clients else 1.0
        out.append(Planned(i, 0.0, int(p[i]), max(1, int(np.ceil(o[i] * keep)))))
    return out


def prompt_tokens(planned: List[Planned], vocab: int, seed: int) -> List[List[int]]:
    """Each request's prompt: token ids uniform over the vocabulary."""
    rng = seed_rng(seed, 99)
    return [rng.integers(0, vocab, size=r.prompt_len).tolist() for r in planned]


def train_batches(cell: dict, vocab: int, seed: int, device):
    """An endless stream of (tokens, targets) [batch, seq], fresh rows every step."""
    b, s = cell["batch"], cell["seq"]
    g = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
    while True:
        rows = torch.randint(0, vocab, (b, s + 1), generator=g, device=device, dtype=torch.int64)
        yield rows[:, :-1].to(torch.int32).contiguous(), rows[:, 1:].to(torch.int32).contiguous()
