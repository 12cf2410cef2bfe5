"""The port's spans (``repro_torch.core.tracing``) on the CPU.

With no profiler recording, a batcher step and a training step open no span and
count no device second. Under a CPU ``torch.profiler.profile``: the batcher's spans
nest as ``serving/batching.py`` lists them; a training step holds each micro-batch's
forward, backward and gradient sum, then the optimizer's clip and update; the MoE
layer's four stages appear forward and as ``.backward`` (under remat "full" and
"dots" the recompute runs the forward stages again, before any backward stage opens),
each stage's backward ending where the one before it in the backward begins, through
both dispatches; every stage counts at most its step's device seconds (host seconds
on the CPU). Tokens, losses and parameters come out bitwise the same with tracing on
and off.
"""
import gc
from collections import Counter

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.config.parallel import ParallelPlan  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core import tracing  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.common import tree_items  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.serving.batching import ContinuousBatcher, Request  # noqa: E402
from repro_torch.training.optimizer import adamw_init  # noqa: E402
from repro_torch.training.train_step import TrainState, build_train_step  # noqa: E402

MOE_STAGES = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")
REQUESTS = [([5, 9, 2, 7], 3), ([11, 3], 4), ([8, 8, 1], 2)]


def _api(arch: str):
    api = build(get_smoke(arch).replace(dtype="float32"), device="cpu")
    return api, api.init_params(torch.Generator().manual_seed(0))


def _serve(api, params):
    batcher = ContinuousBatcher(api, params, num_slots=2, cache_len=16)
    for rid, (prompt, n) in enumerate(REQUESTS):
        batcher.submit(Request(rid, prompt, max_new_tokens=n))
    return batcher.run_to_completion(), batcher


def _train(api, params, remat: str, accum: int = 2, steps: int = 1):
    step = build_train_step(api, ParallelPlan(remat=remat, grad_accum=accum), warmup_steps=1)
    state = TrainState(_clone_tree(params), adamw_init(params), None)
    gen = torch.Generator().manual_seed(1)
    losses = []
    for _ in range(steps):
        tokens = torch.randint(0, api.cfg.vocab_size, (4, 16), generator=gen, dtype=torch.int32)
        targets = torch.randint(0, api.cfg.vocab_size, (4, 16), generator=gen, dtype=torch.int32)
        state, m = step(state, {"tokens": tokens, "targets": targets})
        losses.append(m["loss"].item())
    return losses, state


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.clone()


def _spans(prof):
    """The program's spans: [(name without the prefix, start, end, thread)]."""
    return [(ev.name()[len(tracing.PREFIX):], ev.start_ns(), ev.start_ns() + ev.duration_ns(),
             ev.start_thread_id())
            for ev in prof.profiler.kineto_results.events()
            if ev.name().startswith(tracing.PREFIX)]


def _inside(inner, outer) -> bool:
    return outer[3] == inner[3] and outer[1] <= inner[1] and inner[2] <= outer[2]


def _each_inside(spans, inner: str, outer: str) -> bool:
    outers = [s for s in spans if s[0] == outer]
    return all(any(_inside(s, o) for o in outers) for s in spans if s[0] == inner)


def _profiled(fn):
    before = tracing.device_seconds()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    after = tracing.device_seconds()
    delta = {k: v - before.get(k, 0.0) for k, v in after.items() if v != before.get(k, 0.0)}
    return out, _spans(prof), delta


def test_no_span_and_no_count_without_a_profiler(monkeypatch):
    def opened(*a):
        raise AssertionError("a span opened with no profiler recording")

    monkeypatch.setattr(tracing._Span, "__enter__", opened)
    monkeypatch.setattr(tracing._Stages, "__init__", opened)
    before = tracing.device_seconds()
    assert tracing.span("batcher.step") is tracing.span("train.step", device=True)
    assert tracing.stages() is tracing.stages()
    _serve(*_api("granite-8b"))
    _train(*_api("olmoe-1b-7b"), remat="full")
    assert tracing.device_seconds() == before


def test_batcher_spans_nest_as_listed():
    api, params = _api("granite-8b")
    (got, batcher), spans, delta = _profiled(lambda: _serve(api, params))
    n = Counter(s[0] for s in spans)
    assert n["batcher.prefill"] == n["batcher.insert_slot"] == len(REQUESTS)
    assert n["batcher.decode"] == n["batcher.emit"] == batcher.steps
    assert n["batcher.step"] == n["batcher.admit"] >= batcher.steps
    for inner, outer in (("batcher.admit", "batcher.step"), ("batcher.decode", "batcher.step"),
                         ("batcher.emit", "batcher.step"), ("batcher.prefill", "batcher.admit"),
                         ("batcher.insert_slot", "batcher.admit")):
        assert _each_inside(spans, inner, outer), (inner, outer)
    assert delta == {}   # the batcher's spans are host spans only


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_train_step_spans_and_device_seconds(remat):
    api, params = _api("olmoe-1b-7b")
    layers, accum = api.cfg.num_layers, 2
    _, spans, delta = _profiled(lambda: _train(api, params, remat, accum))
    n = Counter(s[0] for s in spans)
    assert n["train.step"] == n["train.clip"] == n["train.adamw"] == 1
    assert n["train.forward"] == n["train.backward"] == accum
    assert n["train.grad_sum"] == accum + 1
    for name in ("train.forward", "train.backward", "train.grad_sum", "train.clip", "train.adamw"):
        assert _each_inside(spans, name, "train.step"), name
    forward = [s for s in spans if s[0] == "train.forward"]
    backward = [s for s in spans if s[0] == "train.backward"]
    recompute = 1 if remat == "none" else 2
    for stage in MOE_STAGES:
        assert n[stage] == recompute * layers * accum, stage
        assert n[stage + ".backward"] == layers * accum, stage
        # forward stages under train.forward, or (recomputed) under train.backward's call
        assert sum(any(_inside(s, f) for f in forward) for s in spans if s[0] == stage) == \
            layers * accum
        # the backward stages run on the autograd engine's thread, within the backward call
        assert all(any(b[1] <= s[1] and s[2] <= b[2] for b in backward)
                   for s in spans if s[0] == stage + ".backward")
    # the recompute runs before a backward stage opens, never inside one
    for s in spans:
        if s[0] in MOE_STAGES:
            assert not any(_inside(s, b) for b in spans
                           if b[0].startswith("moe.") and b[0].endswith(".backward")), s
    # a layer's stages follow one another: forward in order, backward in reverse
    for names in (MOE_STAGES, tuple(f"{x}.backward" for x in reversed(MOE_STAGES))):
        run = sorted((s for s in spans if s[0] in names), key=lambda s: s[1])
        assert [s[0] for s in run] == list(names) * (len(run) // len(names)), names
        assert all(a[2] <= b[1] for a, b in zip(run, run[1:]) if a[3] == b[3]), names
    step = delta["repro_torch.train.step"]
    timed = [f"train.{x}" for x in ("forward", "backward", "grad_sum", "clip", "adamw")] + \
        list(MOE_STAGES) + [f"{x}.backward" for x in MOE_STAGES]
    for name in timed:
        assert 0.0 < delta[tracing.PREFIX + name] <= step, name
    assert set(delta) == {tracing.PREFIX + x for x in timed + ["train.step"]}


def test_sort_dispatch_stages_forward_and_backward():
    api, params = _api("olmoe-1b-7b")
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params["blocks"]["moe"].items()
         if k in ("router", "w_gate", "w_up", "w_down")}
    p = {k: v[0] for k, v in p.items()}
    x = torch.randn(2, 8, api.cfg.d_model, generator=torch.Generator().manual_seed(2),
                    requires_grad=True)

    def run(dispatch):
        y, aux = moe.apply_moe(x, p, api.cfg, dispatch=dispatch, group_size=8)
        grads = torch.autograd.grad((y.square().sum() + aux), [x] + list(p.values()))
        return [y.detach()] + list(grads)

    want = {d: run(d) for d in ("einsum", "sort")}
    for dispatch in ("einsum", "sort"):
        got, spans, delta = _profiled(lambda: run(dispatch))
        n = Counter(s[0] for s in spans)
        for stage in MOE_STAGES:
            assert n[stage] == n[stage + ".backward"] == 1, (dispatch, stage)
            assert delta[tracing.PREFIX + stage] > 0.0
        assert all(torch.equal(a, b) for a, b in zip(got, want[dispatch])), dispatch


def test_tracing_changes_no_token_loss_or_parameter():
    api, params = _api("olmoe-1b-7b")
    off_tokens, _ = _serve(api, params)
    (on_tokens, _), _, _ = _profiled(lambda: _serve(api, params))
    assert on_tokens == off_tokens
    for remat in ("none", "full", "dots"):
        off_losses, off_state = _train(api, params, remat, steps=2)
        (on_losses, on_state), _, _ = _profiled(lambda: _train(api, params, remat, steps=2))
        assert on_losses == off_losses, remat
        for (path, a), (_, b) in zip(tree_items(on_state.params), tree_items(off_state.params)):
            assert torch.equal(a, b), (remat, path)
        for (path, a), (_, b) in zip(tree_items(on_state.opt.nu), tree_items(off_state.opt.nu)):
            assert torch.equal(a, b), (remat, path)


def test_the_collector_is_a_span_while_tracing():
    def collect():
        with tracing.span("test.outer"):
            gc.collect()

    _, spans, _ = _profiled(collect)
    outer = next(s for s in spans if s[0] == "test.outer")
    assert any(s[0] == "python.gc" and _inside(s, outer) for s in spans)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pass
    gc.collect()   # after the profiler: no span, and none left open
    assert tracing._gc_open == []
    assert _spans(prof) == []


class _Event:
    """A CUDA event's stand-in: completed at once, ``at`` ms on the stream."""

    def __init__(self, at):
        self.at = at

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.at - self.at


def test_a_shared_point_is_recorded_again_once_both_its_pairs_are_read():
    clock = tracing._DeviceClock()
    a, b, c, d, e = (_Event(t) for t in (0.0, 2.0, 5.0, 6.0, 10.0))
    clock.add("x", a, b, shared=True)    # b ends x and starts y
    clock.add("y", b, c)
    clock.add("z", d, e)
    clock.resolve(wait=False)
    assert clock.seconds == pytest.approx({"x": 0.002, "y": 0.003, "z": 0.004})
    assert sorted(map(id, clock.free)) == sorted(map(id, (a, b, c, d, e)))
