"""A run with its timed path broken underneath comes out not correct, under the cells'
own limits: once for each fault a cell can have (one card: no exchange between
chips to leave out). The look for a card is skipped; the rest of the run is the
harness's own, on the CPU at a smoke size."""
import copy
import dataclasses

import pytest

from perfbench import harness
from perfbench.control import half_batch
from perfbench.runners import serve, train
from perfbench.smoke import smoke_cell, smoke_config

SERVED = ["granite-8b.serve.rag", "granite-8b.batch.chat"]
TRAINED = ["olmoe-1b-7b.train.4k", "granite-8b.train.4k"]


def _correct(outcome) -> bool:
    return harness.result_line(outcome, [], False, {})[0]["correct"]


def altered_token(batcher):
    """Every token a decode step produces is replaced where the batcher emits it."""
    inner, vocab = batcher.step, batcher.api.cfg.vocab_size

    def step():
        out = inner()
        by_rid = {r.rid: r for r in batcher.all_requests}
        for i, r in enumerate(batcher.slots):
            if r is not None:
                batcher.cur_tokens[i] = (batcher.cur_tokens[i] + 1) % vocab
        for rid, tok in out:
            by_rid[rid].generated[-1] = (tok + 1) % vocab
        return out
    batcher.step = step


def unchanged_state(batcher):
    """Each decode step runs on a copy of the cache and hands back the old one."""
    decode = batcher.api.decode_step

    def step(p, cache, tokens):
        return decode(p, copy.deepcopy(cache), tokens)[0], cache
    batcher.api = dataclasses.replace(batcher.api, decode_step=step)


@pytest.mark.parametrize("name", SERVED)
@pytest.mark.parametrize("fault", [altered_token, unchanged_state])
def test_a_served_fault_is_not_correct(name, fault, cpu_threads):
    cell, cfg = smoke_cell(name), smoke_config("granite-8b")
    out = serve.run(cell, cfg, 2 ** 35 + 3, 1.0, False, "cpu", 0.0, fault=fault)
    assert not _correct(out), out.checks


def _unchanged(step):
    return lambda state, batch: (state, step(copy.deepcopy(state), batch)[1])


def _loss_altered(step):
    def run(state, batch):
        state, m = step(state, batch)
        return state, dict(m, loss=m["loss"] * 1.01)
    return run


@pytest.mark.parametrize("name", TRAINED)
@pytest.mark.parametrize("hook", [_unchanged, half_batch, _loss_altered])
def test_a_training_fault_is_not_correct(name, hook, cpu_threads):
    cell = smoke_cell(name)
    cfg = smoke_config(harness.load_json(harness.HERE / "workloads" / f"{name}.json")["config"])
    seed = 2 ** 35 + 5
    e2e, rec, got, steps, failed, peak = train.program_steps(cell, cfg, seed, 0.2, False, "cpu",
                                                             0.0, step_hook=hook)
    want = train.reference_steps(cell, cfg, seed, "cpu")
    out = harness.Outcome(e2e, rec, train.compare(cell, got, want), steps, failed, peak)
    assert not _correct(out), out.checks
