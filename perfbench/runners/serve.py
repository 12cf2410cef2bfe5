"""A served cell: ``repro_torch``'s ``ContinuousBatcher`` over ``models.model.build``,
fed by the cell's open or closed loop, measured over the window, then checked
against the plain reference.

The lead-in runs the traffic before the window opens, so the window starts at the
mix's steady occupancy; it counts as set-up. In a traced run the window's first
``trace_seconds`` run under the profiler with the kernel calls recorded, and the rest
with the benchmark's spans around ``prefill`` and ``decode_step`` (each up to the
device's synchronize), so neither perturbs the other's reading.

``correct``: once the window has closed and the program's state is freed, the
reference runs over a sample of the finished requests drawn from the seed, the
longest among them: each prompt with its served tokens, in float32. The number
compared is the widest gap by which a served token's logit lies below the
reference's best at its position.
"""
from __future__ import annotations

import bisect
import dataclasses
import gc
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import program, stats
from perfbench.harness import Check, Outcome, Record
from perfbench.reference import for_config
from perfbench.tracing import KernelCalls, profiled, profiled_warm
from perfbench.traffic import generator


def clock() -> float:
    return time.perf_counter()


def log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


class Spans:
    """The benchmark's wrappers on its own ``api``'s ``prefill`` and ``decode_step``:
    each prefill's start (the queue waits are matched to them FIFO) and its prompt
    tokens against the positions it was handed; while ``on``, the calls' times up to
    the device's synchronize and the prefilled prompts' model FLOPs (the configuration's
    reference module's ``prefill_flops``)."""

    def __init__(self, api, config: dict):
        self.api, self.config, self.on = api, config, False
        self.flops = for_config(config).prefill_flops
        self.prefill_starts: List[float] = []
        self.positions = self.prompt_tokens = 0
        self.spans: Dict[str, list] = {"prefill": [], "decode_step": []}
        self.prefill_flops = 0.0

    def wrapped(self):
        return dataclasses.replace(self.api, prefill=self.prefill, decode_step=self.decode_step)

    def prefill(self, p, tokens, plens, **kw):
        t0 = clock()
        self.prefill_starts.append(t0)
        out = self.api.prefill(p, tokens, plens, **kw)
        if tokens.is_cuda:
            torch.cuda.synchronize()
        t1 = clock()
        n = int(plens.sum())
        self.positions += tokens.numel()
        self.prompt_tokens += n
        if self.on:
            self.spans["prefill"].append((t0, t1))
            self.prefill_flops += sum(self.flops(self.config, int(x)) for x in plens.tolist())
        return out

    def decode_step(self, p, c, t):
        t0 = clock()
        out = self.api.decode_step(p, c, t)
        if t.is_cuda:
            torch.cuda.synchronize()
        if self.on:
            self.spans["decode_step"].append((t0, clock()))
        return out


def run(cell: dict, config: dict, seed: int, seconds: float, trace: bool, device,
        t_process: float, check: bool = True, fault=None) -> Outcome:
    """One run of the cell. ``check`` False skips the comparison (``perfbench.sweep``);
    ``fault(batcher)`` plants a fault in the timed path (the tests)."""
    from repro_torch.serving.batching import ContinuousBatcher, Request

    t_build = clock()
    ref = for_config(config)
    api, params = program.build(config, seed, device)
    spans = Spans(api, config)
    batcher = ContinuousBatcher(spans.wrapped() if trace else api, params,
                                num_slots=cell["slots"], cache_len=cell["cache_len"])
    if fault is not None:
        fault(batcher)
    # warm-up: the cell's two shapes, a prefill at the cache length and a decode step of
    # every slot
    warm = Request(-1, [1] * 16, max_new_tokens=2)
    batcher.submit(warm)
    while not warm.done:
        batcher.step()
    spans.prefill_starts.clear()
    spans.positions = spans.prompt_tokens = 0
    # the host paces the decode step: one thread of its own, and the set-up's objects
    # out of the collector's way
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    gc.collect()
    gc.freeze()
    t_warm = clock()

    loop = cell["arrivals"]["loop"]
    plan = (generator.open_loop(cell, seed, seconds) if loop == "open"
            else generator.closed_loop(cell, seed))
    prompts = generator.prompt_tokens(plan, int(config["vocab_size"]), seed)
    times: Dict[int, List[float]] = {}
    due_at: Dict[int, float] = {}
    by_rid: Dict[int, Request] = {}
    submitted: List[Request] = []
    in_flight: List[Request] = []
    decode_flops = [0.0]
    load: List[tuple] = []       # (time, active slots, waiting) after each step
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()

    t_open = clock() + cell["arrivals"]["lead_in_s"]
    t_close = t_open + seconds
    nxt = [0]                    # the next request to send

    def submit(now: float) -> None:
        j = nxt[0]
        nxt[0] += 1
        p = plan[j % len(plan)]
        r = Request(j, prompts[j % len(plan)], max_new_tokens=p.output_len)
        due = t_open + p.due if loop == "open" else now
        by_rid[j], due_at[j], times[j] = r, due, []
        r.arrival = due
        batcher.submit(r)
        submitted.append(r)
        in_flight.append(r)

    def drive(until: float) -> None:
        while True:
            now = clock()
            if loop == "open":
                while nxt[0] < len(plan) and t_open + plan[nxt[0]].due <= now:
                    submit(now)
            else:
                while len(in_flight) < cell["arrivals"]["clients"]:
                    submit(now)
            if now >= until:
                return
            if not batcher.waiting and batcher.active == 0:
                wake = t_open + plan[nxt[0]].due if loop == "open" and nxt[0] < len(plan) else until
                time.sleep(max(0.0, min(wake, until) - now))
                continue
            out = batcher.step()
            t = clock()
            load.append((t, batcher.active, len(batcher.waiting)))
            for rid, _ in out:
                times[rid].append(t)
                if spans.on:
                    r = by_rid[rid]
                    decode_flops[0] += ref.decode_flops(config, len(r.prompt) + len(r.generated) - 1)
            in_flight[:] = [r for r in in_flight if not r.done]

    if trace:
        profiled_warm()
    drive(t_open)
    waiting_at_open = len(batcher.waiting)
    record = Record(cell, config)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t_trace = t_close
    if trace:   # spans first, then the profiler over the window's last trace_seconds
        t_trace = max(t_open, t_close - cell["trace_seconds"])
        spans.on = True
        drive(t_trace)
        spans.on = False
        traces: list = []
        calls = KernelCalls()
        with profiled(traces):
            calls.install()
            try:
                drive(t_close)
            finally:
                calls.remove()
        record.device = traces[0]
        record.kernel_costs = calls.costs()
    else:
        drive(t_close)
    t_end = clock()
    peak = (torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0)
    waiting_at_close = len(batcher.waiting)

    # the window's numbers
    first = {r.rid: (r.first_token_at if r.generated else None) for r in submitted}
    for r in submitted:
        if r.generated:
            times[r.rid].insert(0, r.first_token_at)
    e2e: Dict[str, float] = {"setup_s": t_open - t_process}
    in_window = [r for r in submitted if not r.done or times[r.rid][-1] >= t_open]
    if loop == "open":
        due_in = [r for r in submitted if t_open <= due_at[r.rid] < t_close]
        tt = stats.ttfts([due_at[r.rid] for r in due_in], [first[r.rid] for r in due_in],
                         t_open, t_close)
        e2e["ttft_p90_ms"] = 1e3 * stats.percentile(tt, 90)
        tp = stats.tpots([times[r.rid] for r in submitted], t_open, t_close)
        e2e["tpot_p90_ms"] = 1e3 * stats.percentile(tp, 90)
        attempted = len(due_in)
    else:
        attempted = len(in_window)
    e2e["output_tokens_per_s"] = stats.tokens_in(times.values(), t_open, t_close) / seconds
    e2e["waiting_at_open"], e2e["waiting_at_close"] = waiting_at_open, waiting_at_close
    inside = [x for x in load if t_open <= x[0] <= t_close] or [(0.0, 0, 0)]
    e2e["active_mean"] = sum(x[1] for x in inside) / len(inside)
    e2e["waiting_max"] = max(x[2] for x in inside)
    e2e["live_cache_share"] = _live_positions(submitted, times, [x[0] for x in inside]) / (
        cell["slots"] * cell["cache_len"])

    if trace:
        record.span_window = (t_open, t_trace)
        record.spans = spans.spans
        tpots_untraced = stats.tpots([times[r.rid] for r in submitted], t_open, t_trace)
        waits = [s - due_at[r.rid] for r, s in zip(submitted, spans.prefill_starts)
                 if t_open <= due_at[r.rid] < t_trace]
        record.counters = {"prefill_positions": spans.positions,
                           "prefill_prompt_tokens": spans.prompt_tokens,
                           "queue_waits": waits, "prefill_flops": spans.prefill_flops,
                           "decode_flops": decode_flops[0], "tpots": tpots_untraced}

    vocab = int(config["vocab_size"])
    finished = [r for r in submitted if r.done]
    failed = sum(1 for r in finished if len(r.generated) != r.max_new_tokens
                 or min(r.generated) < 0 or max(r.generated) >= vocab)
    sample = _sample(finished, cell["check"]["requests"], seed)
    served = [(r.prompt, list(r.generated)) for r in sample]

    del batcher, spans, params, api
    gc.unfreeze()
    gc.collect()
    torch.set_num_threads(threads)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    checks = []
    t_check = clock()
    if check:
        gap = widest_gap(config, seed, served, device)
        checks = [Check("widest_logit_gap", gap, cell["check"]["limits"]["widest_logit_gap"]),
                  Check("requests_compared_short", float(cell["check"]["requests"] - len(sample)),
                        0.0)]
    log(f"set-up {t_open - t_process:.2f} s (to the build {t_build - t_process:.2f}, build and "
        f"warm-up {t_warm - t_build:.2f}, lead-in {t_open - t_warm:.2f}); window {t_end - t_open:.2f} s; "
        f"check {clock() - t_check:.2f} s over {sum(len(g) for _, g in served)} served tokens")
    log(f"in the window: {e2e['active_mean']:.1f} of {cell['slots']} slots in use, "
        f"{100 * e2e['live_cache_share']:.1f}% of the cache's positions live "
        f"({cell['slots']} x {cell['cache_len']}, {ref.cache_bytes(config, cell) / 1e9:.2f} GB "
        f"reserved); waiting at most {e2e['waiting_max']}, {waiting_at_close} at the close")
    if loop == "open":
        log(f"in the window: ttft p90 {e2e['ttft_p90_ms']!r} ms, tpot p90 {e2e['tpot_p90_ms']!r} ms")
    return Outcome(e2e, record, checks, attempted, failed, int(peak), served)


def _live_positions(requests: list, times: Dict[int, List[float]], at: List[float]) -> float:
    """The mean, over the times ``at``, of the cache positions that requests in a slot
    hold: each from its first token to its last, its prompt and its tokens so far."""
    total = 0
    for r in requests:
        t = times[r.rid]
        if not t:
            continue
        end = t[-1] if r.done else float("inf")
        total += sum(len(r.prompt) + bisect.bisect_right(t, x) for x in at if t[0] <= x <= end)
    return total / max(1, len(at))


def _sample(finished: list, k: int, seed: int) -> list:
    """The longest finished request (prompt and served tokens) and k - 1 more drawn
    from the seed."""
    if not finished:
        return []
    longest = max(finished, key=lambda r: (len(r.prompt) + len(r.generated), -r.rid))
    rest = [r for r in finished if r is not longest]
    rng = generator.seed_rng(seed, 7)
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False) if rest else []
    return [longest] + [rest[i] for i in sorted(pick)]


def token_gaps(config: dict, seed: int, served, device, quant: Optional[str] = None,
               params=None) -> List[np.ndarray]:
    """For each (prompt, served tokens): the reference's (float32) best logit minus its
    logit of each served token. With ``quant`` the served tokens are instead the ones
    the reference in that precision puts first (the control). The reference is the
    configuration's own module."""
    ref = for_config(config)
    a = ref.Arch.from_config(config)
    ref.no_tf32()
    params = params if params is not None else ref.make_weights(a, seed, device)
    out = []
    for prompt, gen in served:
        seq = torch.tensor(prompt + gen[:-1], dtype=torch.int64, device=device)
        rows = torch.arange(len(prompt) - 1, len(prompt) - 1 + len(gen), device=device)
        logits = ref.next_token_logits(params, seq, rows, a)
        if quant is None:
            tok = torch.tensor(gen, dtype=torch.int64, device=device)
        else:
            tok = ref.next_token_logits(params, seq, rows, a, quant=quant).argmax(dim=-1)
        g = logits.max(dim=-1).values - logits.gather(1, tok[:, None])[:, 0]
        out.append(g.cpu().numpy())
    return out


def widest_gap(config: dict, seed: int, served, device) -> float:
    if not served:
        return float("inf")
    return float(max(g.max() for g in token_gaps(config, seed, served, device)))
