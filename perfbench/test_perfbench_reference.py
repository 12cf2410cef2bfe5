"""The plain reference against the port's CPU path at a smoke size, in float32: the
training loss and every leaf's gradient, and the served logits of a prefill and of
decode steps through the slot cache. And the reference loads nothing of the program."""
import subprocess
import sys

import pytest
import torch

from perfbench import program
from perfbench.reference import for_config
from perfbench.smoke import ROOT, smoke_config


def _f32(tree):
    return {k: _f32(v) if isinstance(v, dict) else v.float() for k, v in tree.items()}


@pytest.mark.parametrize("name", ["granite-8b", "olmoe-1b-7b"])
def test_training_loss_and_gradients_match_the_port(name, cpu_threads):
    from repro_torch.models.model import build
    cfg = dict(smoke_config(name), torch_dtype="float32")
    api = build(program.model_config(cfg), device="cpu")
    ref = for_config(cfg)
    a = ref.Arch.from_config(cfg)
    w = _f32(ref.make_weights(a, 2 ** 33 + 1, "cpu"))
    rows = torch.randint(0, a.vocab, (2, 65), generator=torch.Generator().manual_seed(1))
    tok, tgt = rows[:, :-1].int(), rows[:, 1:].int()
    leaves = [t.requires_grad_(True) for _, t in ref.leaves(w)]
    lp = api.train_loss(w, {"tokens": tok, "targets": tgt}, remat="none")
    lr = ref.train_loss(w, tok, tgt, a)
    assert float(lp.detach()) == pytest.approx(float(lr.detach()), rel=1e-5)
    for (path, _), x, y in zip(ref.leaves(w), torch.autograd.grad(lp, leaves),
                               torch.autograd.grad(lr, leaves)):
        assert float((x - y).norm()) <= 1e-4 * float(y.norm()) + 1e-7, path


def test_served_logits_match_the_port(cpu_threads):
    from repro_torch.models.model import build
    from repro_torch.serving.batching import insert_slot, _batch_axes
    cfg = dict(smoke_config("granite-8b"), torch_dtype="float32")
    api = build(program.model_config(cfg), device="cpu")
    ref = for_config(cfg)
    a = ref.Arch.from_config(cfg)
    w = _f32(ref.make_weights(a, 77, "cpu"))
    g = torch.Generator().manual_seed(2)
    prompt = torch.randint(0, a.vocab, (11,), generator=g)
    gen = torch.randint(0, a.vocab, (5,), generator=g)
    cache_len, slots = 32, 3
    with torch.inference_mode():
        tokens = torch.zeros((1, cache_len), dtype=torch.int32)
        tokens[0, :11] = prompt
        logits, one = api.prefill(w, tokens, torch.tensor([11], dtype=torch.int32))
        cache = api.init_cache(slots, cache_len)
        insert_slot(cache, one, 1, _batch_axes(api, slots, cache_len))
        got = [logits[0]]
        for t in gen[:-1]:
            step = torch.randint(0, a.vocab, (slots,), generator=g, dtype=torch.int32)
            step[1] = t
            out, cache = api.decode_step(w, cache, step)
            got.append(out[1])
    seq = torch.cat([prompt, gen[:-1]])
    want = ref.next_token_logits(w, seq, torch.arange(10, 15), a)
    got = torch.stack(got)
    assert torch.allclose(got[0], want[0], atol=1e-5, rtol=1e-5)
    # decoding reads K and V from the cache, which the program keeps in bf16 (2^-9)
    assert torch.allclose(got[1:], want[1:], atol=5e-3 * float(want.abs().max()), rtol=0)


def test_the_reference_loads_nothing_of_the_program_or_jax():
    code = ("import sys; sys.path[0:0] = [%r]; import perfbench.reference.model, "
            "perfbench.runners.train, perfbench.runners.serve, perfbench.smoke; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(ROOT))
    names = eval(subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                                check=True, timeout=120).stdout)
    assert not set(names) & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_the_import_check_compares_whole_names():
    from perfbench import harness
    assert harness.forbidden_modules(["repro_torch.kernels", "jaxtyping", "reproducible",
                                      "flaxen", "torch"]) == []
    assert harness.forbidden_modules(["jax.numpy", "repro.models", "jaxlib", "flax", "repro_torch"]) \
        == ["flax", "jax", "jaxlib", "repro"]
