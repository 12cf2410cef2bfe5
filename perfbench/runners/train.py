"""A training cell: the step ``repro_torch.training.train_step.build_train_step``
returns, over the benchmark's weights and a fresh batch of rows from the seed every
step.

Set-up builds the one training state and drives it through the cell's first
``check.steps`` steps, through the window's own call and feed; they are also the
warm-up. The window then runs whole steps until its time is over. In a traced run
its first ``trace_seconds`` run under the profiler with the kernel calls recorded.

``correct``: once the window has closed and the program's state is freed, the plain
reference (float32, TF32 off, parameters stored in the configuration's bfloat16 as
the program stores them) runs the same first steps on the same rows. Compared, each
by its worst part: every step's loss (relative gap); the norm of each parameter's
first gradient as the optimizer got it (the program's from its first moment after
one step), a stacked leaf layer by layer; and the norm of each parameter's change
over the first steps, the leaves whose reference gradient is under a thousandth of
the median leaf's left out. A norm's gap is taken against the reference's norm of
that leaf or of the median leaf, whichever is larger.
"""
from __future__ import annotations

import gc
import math
import sys
import time
from typing import Dict, List, Tuple

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


def lr_at(opt: dict, step: int) -> float:
    """The cell's learning rate at ``step`` (from 0): linear warmup, then a cosine to 0,
    in float32."""
    f32 = np.float32
    s, warm, total = f32(step), opt["warmup_steps"], opt["total_steps"]
    if s < warm:
        return float(f32(opt["lr"]) * (s + f32(1)) / f32(max(1, warm)))
    prog = np.clip((s - f32(warm)) / f32(max(1, total - warm)), f32(0), f32(1))
    return float(f32(opt["lr"]) * f32(0.5) * (f32(1) + np.cos(f32(math.pi) * prog)))


def worst_gap(got: Dict[str, float], want: Dict[str, float], keys) -> Tuple[float, str]:
    """(the largest gap of a leaf's norms, that leaf)."""
    keys = list(keys)
    floor = float(np.median([want[k] for k in keys]))
    return max((abs(got[k] - want[k]) / max(want[k], floor), k) for k in keys)


def program_steps(cell: dict, config: dict, seed: int, seconds: float, trace: bool, device,
                  t_process: float, step_hook=None):
    """Set-up, the window and its numbers. ``step_hook(step_fn) -> step_fn`` lets a
    test plant a fault in the timed path."""
    from repro_torch.config.parallel import ParallelPlan
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train_step import TrainState, build_train_step

    opt, k = cell["optimizer"], cell["check"]["steps"]
    t_build = clock()
    api, params = program.build(config, seed, device)
    plan = ParallelPlan(remat=cell["remat"], grad_accum=cell["micro_batches"])
    step = build_train_step(api, plan, lr=opt["lr"], weight_decay=opt["weight_decay"],
                            warmup_steps=opt["warmup_steps"], total_steps=opt["total_steps"])
    if step_hook is not None:
        step = step_hook(step)
    state = TrainState(params=params, opt=adamw_init(params), residual=None)
    feed = generator.train_batches(cell, int(config["vocab_size"]), seed, device)
    ref = for_config(config)
    a = ref.Arch.from_config(config)

    def one(state):
        tokens, targets = next(feed)
        t0 = clock()
        state, m = step(state, {"tokens": tokens, "targets": targets})
        loss = float(m["loss"].item())
        return state, loss, (t0, clock())

    losses: List[float] = []
    first_grad = change = None
    t_steps = clock()
    for i in range(k):
        state, loss, _ = one(state)
        losses.append(loss)
        if i == 0:   # the first moment after one step: (1 - b1) x the gradient it got
            first_grad = program.layer_norms(ref, state.opt.mu, lambda t: t / 0.1)
        if i == k - 1:
            change = _change_norms(ref, list(ref.leaves(state.params)), a, seed, device)

    if trace:
        profiled_warm()
    t_open = clock()
    record = Record(cell, config)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    close = t_open + seconds
    window, failed = [], 0

    def drive(state, until):
        nonlocal failed
        spans = []
        while clock() < until:
            state, loss, span = one(state)
            spans.append(span)
            failed += 0 if math.isfinite(loss) else 1
        return state, spans

    if trace:   # spans first, then the profiler over the window's last trace_seconds
        state, window = drive(state, max(t_open, close - cell["trace_seconds"]))
        traces: list = []
        calls = KernelCalls()
        with profiled(traces):
            calls.install()
            try:
                state, traced = drive(state, close)
            finally:
                calls.remove()
        record.device = traces[0]
        record.kernel_costs = calls.costs()
        record.spans = {"train_step": list(window)}
        record.counters = {"train_step_flops": ref.train_flops(config, cell["batch"], cell["seq"])}
        window += traced
    else:
        state, window = drive(state, close)
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0
    tokens = cell["batch"] * cell["seq"]
    e2e = {"setup_s": t_open - t_process,
           "train_tokens_per_s": stats.rate_over_steps(window, tokens)}
    del state, step, feed, params, api
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    log(f"set-up {t_open - t_process:.2f} s (to the build {t_build - t_process:.2f}, build "
        f"{t_steps - t_build:.2f}, the first {k} steps {t_open - t_steps:.2f}); window "
        f"{clock() - t_open:.2f} s, {len(window)} steps")
    return e2e, record, {"loss": losses, "first_grad": first_grad, "change": change}, \
        len(window), failed, int(peak)


def _change_norms(ref, named, a, seed: int, device) -> Dict[str, float]:
    """Each leaf's (by layer) norm of its change from the weights it started from,
    drawn again leaf by leaf by the reference module ``ref``. ``named``: (stacked path,
    a tensor or the list of its layers)."""
    out = {}
    for path, p in named:
        p0 = ref.make_leaf(a, seed, path, device)
        name = "/".join(path)
        if path[0] == "blocks":
            vals = torch.stack([(p[i].detach().float() - p0[i].float()).norm()
                                for i in range(len(p))]).tolist()
            out.update({f"{name}/{i}": v for i, v in enumerate(vals)})
        else:
            out[name] = float((p.detach().float() - p0.float()).norm())
        del p0
    return out


def reference_steps(cell: dict, config: dict, seed: int, device, quant=None) -> dict:
    """The cell's first ``check.steps`` steps in the plain reference (``quant``: the
    control's lower precision): each step's loss, the first clipped gradient's norms
    and the change's norms, leaf by leaf (stacked leaves by layer). The reference is the
    configuration's own module."""
    ref = for_config(config)
    a = ref.Arch.from_config(config)
    ref.no_tf32()
    opt, k, micro = cell["optimizer"], cell["check"]["steps"], cell["micro_batches"]
    stacked = ref.make_weights(a, seed, device)
    decay = {p: t.dim() >= 2 for p, t in ref.leaves(stacked)}   # as stacked, like the program
    store = {p: t.dtype for p, t in ref.leaves(stacked)}
    params = ref.split_layers(stacked, a)
    del stacked
    names, leaves_ = _named_leaves(ref, params)
    for t in leaves_:
        t.requires_grad_(True)
    # AdamW's moments wait on the host between steps: on the card beside the float32
    # weights, gradients and activations they would not fit
    m: List = [None] * len(leaves_)
    v: List = [None] * len(leaves_)
    feed = generator.train_batches(cell, a.vocab, seed, device)
    losses, first_grad = [], None
    b1, b2, eps = 0.9, 0.95, 1e-8
    for i in range(k):
        tokens, targets = next(feed)
        n = tokens.shape[0] // micro
        total = 0.0
        for j in range(micro):
            loss = ref.train_loss(params, tokens[j * n:(j + 1) * n], targets[j * n:(j + 1) * n], a,
                                  quant)
            (loss / micro).backward()
            total += float(loss.detach())
        losses.append(total / micro)
        with torch.no_grad():
            grads = [torch.zeros_like(t) if t.grad is None else t.grad for t in leaves_]  # unused: 0
            gnorm = torch.sqrt(sum(g.square().sum() for g in grads))
            scale = torch.clamp(1.0 / torch.clamp(gnorm, min=1e-12), max=1.0)
            if i == 0:
                first_grad = dict(zip(names, torch.stack([g.norm() * scale for g in grads]).tolist()))
            lr = lr_at(opt, i)
            bc1, bc2 = 1.0 - b1 ** (i + 1), 1.0 - b2 ** (i + 1)
            for j, (name, t, g) in enumerate(zip(names, leaves_, grads)):
                g = g * scale
                mi = torch.zeros_like(t) if m[j] is None else m[j].to(device)
                vi = torch.zeros_like(t) if v[j] is None else v[j].to(device)
                mi.mul_(b1).add_(g, alpha=1 - b1)
                vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                upd = (mi / bc1) / ((vi / bc2).sqrt() + eps)
                if i < k - 1:
                    m[j], v[j] = mi.to("cpu"), vi.to("cpu")
                wd = opt["weight_decay"] if decay[_stacked_path(name)] else 0.0
                new = t - lr * (upd + wd * t)
                t.copy_(new.to(store[_stacked_path(name)]).float())   # stored as configured
                t.grad = None
    by_name = dict(zip(names, leaves_))
    layered = [(path, [by_name[f"{'/'.join(path)}/{i}"] for i in range(a.layers)]
                if path[0] == "blocks" else by_name["/".join(path)])
               for path, *_ in ref.weight_spec(a)]
    change = _change_norms(ref, layered, a, seed, device)
    return {"loss": losses, "first_grad": first_grad, "change": change}


def _named_leaves(ref, params):
    """(names as ``program.layer_norms`` gives them, leaves) of a per-layer tree."""
    names, out = [], []
    for key, val in params.items():
        if key == "blocks":
            for i, layer in enumerate(val):
                for path, t in ref.leaves(layer):
                    names.append("/".join(("blocks",) + path) + f"/{i}")
                    out.append(t)
        else:
            names.append(key)
            out.append(val)
    return names, out


def _stacked_path(name: str):
    parts = tuple(name.split("/"))
    return parts[:-1] if parts[0] == "blocks" else parts


def compare(cell: dict, got: dict, want: dict) -> List[Check]:
    lim = cell["check"]["limits"]
    loss = max(abs(g - w) / abs(w) for g, w in zip(got["loss"], want["loss"]))
    floor = float(np.median(list(want["first_grad"].values())))
    moving = [n for n, g in want["first_grad"].items() if g >= 1e-3 * floor]
    grad, grad_leaf = worst_gap(got["first_grad"], want["first_grad"], want["first_grad"])
    change, change_leaf = worst_gap(got["change"], want["change"], moving)
    log(f"losses {got['loss']} against {want['loss']}; worst leaves: first gradient {grad_leaf}, "
        f"change {change_leaf}; {len(want['change']) - len(moving)} leaves left out of the change")
    return [Check("loss_gap", loss, lim["loss_gap"]),
            Check("first_grad_gap", grad, lim["first_grad_gap"]),
            Check("change_gap", change, lim["change_gap"])]


def run(cell: dict, config: dict, seed: int, seconds: float, trace: bool, device,
        t_process: float) -> Outcome:
    e2e, record, got, steps, failed, peak = program_steps(cell, config, seed, seconds, trace,
                                                          device, t_process)
    t = clock()
    want = reference_steps(cell, config, seed, device)
    log(f"check {clock() - t:.2f} s")
    return Outcome(e2e, record, compare(cell, got, want), steps, failed, peak)
