"""The traffic generator: every seed gives the same work (an open loop the same
arrivals), the sizes in another order, and a seed repeats."""
import numpy as np
import torch

from perfbench.smoke import smoke_cell
from perfbench.traffic import generator


def test_open_loop_repeats_by_seed_and_keeps_the_work():
    cell = smoke_cell("granite-8b.serve.rag")
    a = generator.open_loop(cell, 2 ** 31 + 7, 10.0)
    assert a == generator.open_loop(cell, 2 ** 31 + 7, 10.0)
    b = generator.open_loop(cell, 5, 10.0)
    assert a != b
    for plan in (a, b):
        win = [p for p in plan if p.due >= 0]
        assert len(win) == round(cell["arrivals"]["rate_per_s"] * 10.0)
        assert all(0 <= p.due < 10.0 for p in win)
        lead = [p for p in plan if p.due < 0]
        assert all(-cell["arrivals"]["lead_in_s"] <= p.due for p in lead)
        assert [p.due for p in plan] == sorted(p.due for p in plan)
    assert sorted(p.prompt_len for p in a if p.due >= 0) == sorted(p.prompt_len for p in b if p.due >= 0)
    assert sorted(p.output_len for p in a if p.due >= 0) == sorted(p.output_len for p in b if p.due >= 0)
    assert [p.prompt_len for p in a] != [p.prompt_len for p in b]   # another order
    assert [p.due for p in a] == [p.due for p in b]                 # the same schedule


def test_lengths_stay_in_their_bounds():
    cell = smoke_cell("granite-8b.serve.rag")
    for p in generator.open_loop(cell, 11, 20.0):
        assert cell["prompt_tokens"]["min"] <= p.prompt_len <= cell["prompt_tokens"]["max"]
        assert cell["output_tokens"]["min"] <= p.output_len <= cell["output_tokens"]["max"]


def test_closed_loop_staggers_the_first_cohort():
    cell = smoke_cell("granite-8b.batch.chat")
    plan = generator.closed_loop(cell, 3)
    assert plan == generator.closed_loop(cell, 3)
    n = cell["arrivals"]["clients"]
    full = generator.closed_loop(dict(cell, arrivals=dict(cell["arrivals"], clients=1)), 3)
    for i in range(n):
        assert plan[i].output_len == max(1, int(np.ceil(full[i].output_len * (i + 1) / n)))
    assert [p.output_len for p in plan[n:]] == [p.output_len for p in full[n:]]
    other = generator.closed_loop(cell, 4)
    assert sorted(p.prompt_len for p in other) == sorted(p.prompt_len for p in plan)


def test_prompts_and_training_rows_repeat_by_seed():
    cell = smoke_cell("granite-8b.serve.rag")
    plan = generator.open_loop(cell, 9, 2.0)
    assert generator.prompt_tokens(plan, 256, 9) == generator.prompt_tokens(plan, 256, 9)
    assert generator.prompt_tokens(plan, 256, 9) != generator.prompt_tokens(plan, 256, 10)
    train = smoke_cell("olmoe-1b-7b.train.4k")
    a, b = generator.train_batches(train, 256, 2 ** 40, "cpu"), generator.train_batches(train, 256, 2 ** 40, "cpu")
    x1, x2 = next(a), next(a)
    assert torch.equal(x1[0], next(b)[0]) and not torch.equal(x1[0], x2[0])
    assert torch.equal(x1[0][:, 1:], x1[1][:, :-1])
    assert x1[0].shape == (train["batch"], train["seq"]) and x1[0].dtype == torch.int32
