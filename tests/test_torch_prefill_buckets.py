"""The batcher's prefill lengths (``serving.batching.prefill_length``).

The port's batcher prefills a prompt at the next multiple of 256 positions
(capped at the cache, on each family's grid) and writes only that span into
its slot; the JAX package's batcher pads every prompt to the cache length.
At a cache longer than 256 the two must still give the same token streams,
the same ``slot_pos`` and ``pos``, and K/V within the bf16 cache's tolerance
wherever a slot holds a position. hymba's reference is the port's own batcher
padded to the cache: the JAX package's hybrid prefill keeps the padded
sequence's last window rather than the prompt's (``test_torch_model.py``,
ROADMAP.md C), so it agrees with any batcher only where prompts fill the cache.

Weights are float32 smoke weights, from ``repro``'s ``init_params`` carried
across by ``repro_torch.bridge`` where the JAX batcher is the reference;
prompts come from a numpy seed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.models.model import build as jax_build  # noqa: E402
from repro.serving.batching import ContinuousBatcher as JaxBatcher  # noqa: E402
from repro.serving.batching import Request as JaxRequest  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.models.common import tree_items  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.serving import batching  # noqa: E402
from repro_torch.serving.batching import (PREFILL_QUANTUM, ContinuousBatcher, Request,  # noqa: E402
                                          prefill_length)

CACHE_TOL = dict(rtol=3e-2, atol=3e-2)   # tests/test_kernels.py::_tol, the bf16 cache
MAX_NEW = 4


# ------------------------------------------------------------------ the rule
@pytest.mark.parametrize("arch,n,room,want", [
    # dense: the next multiple of 256, capped at the room
    ("granite-8b", 1, 4096, 256), ("granite-8b", 255, 4096, 256), ("granite-8b", 256, 4096, 256),
    ("granite-8b", 257, 4096, 512), ("granite-8b", 4096, 4096, 4096), ("granite-8b", 0, 4096, 256),
    # a room that is not a multiple of 256
    ("granite-8b", 700, 1000, 768), ("granite-8b", 900, 1000, 1000), ("granite-8b", 1000, 1000, 1000),
    ("granite-8b", 5, 200, 200),
    # moe: multiples of the routing group above it, the room at or below it
    ("olmoe-1b-7b", 10, 4096, 1024), ("olmoe-1b-7b", 1024, 4096, 1024),
    ("olmoe-1b-7b", 1025, 4096, 2048), ("olmoe-1b-7b", 3000, 4096, 3072),
    ("olmoe-1b-7b", 10, 1024, 1024), ("olmoe-1b-7b", 10, 512, 512),
    # hybrid (window 1024): never below min(window, room)
    ("hymba-1.5b", 10, 4096, 1024), ("hymba-1.5b", 1100, 4096, 1280), ("hymba-1.5b", 10, 600, 600),
    ("hymba-1.5b", 2000, 2048, 2048),
    # ssm: the quantum alone
    ("mamba2-130m", 300, 4096, 512),
    # vlm: the text's room after its 256 patches
    ("internvl2-76b", 300, 4096 - 256, 512), ("internvl2-76b", 3800, 4096 - 256, 3840),
    # encdec: the quantum alone
    ("whisper-base", 10, 448, 256), ("whisper-base", 300, 448, 448),
])
def test_prefill_length(arch, n, room, want):
    got = prefill_length(n, room, get_config(arch))
    assert got == want
    assert min(max(n, 1), room) <= got <= room
    assert got == room or got % PREFILL_QUANTUM == 0


# ------------------------------------------ the batcher against a padded one
# arch: (cache_len, prompt lengths). With two slots and equal answers, slot 0
# serves the even requests and slot 1 the odd ones: slot 0 takes a shorter
# prompt after a longer one, whose positions past the shorter bucket must read
# as empty. olmoe's cache is over one routing group, so its buckets are 1024.
CASES = {"granite-8b": (320, [300, 5, 9, 270, 4]),
         "olmoe-1b-7b": (2048, [1100, 5, 9, 4]),
         "mamba2-130m": (320, [300, 5, 9, 270, 4]),
         "hymba-1.5b": (320, [300, 5, 9, 270, 4])}


def _prompts(lens, vocab):
    rng = np.random.default_rng(5)
    return [rng.integers(0, vocab, size=n).tolist() for n in lens]


def _serve(batcher_cls, request_cls, api, params, cache_len, prompts):
    batcher = batcher_cls(api, params, num_slots=2, cache_len=cache_len)
    for rid, prompt in enumerate(prompts):
        batcher.submit(request_cls(rid, prompt, max_new_tokens=MAX_NEW))
    return batcher.run_to_completion(), batcher


def _models(arch):
    """(jax api, jax params, port api, port params) of the float32 smoke config."""
    japi = jax_build(jax_get_smoke(arch).replace(dtype="float32"))
    jparams = japi.init_params(jax.random.PRNGKey(0))
    api = build(get_smoke(arch).replace(dtype="float32"), device="cpu")
    params = bridge.from_numpy_tree(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return japi, jparams, api, params


def _flat_numpy(cache, jax_tree: bool):
    if jax_tree:
        return {"/".join(str(p.key) for p in path): np.asarray(leaf)
                for path, leaf in jax.tree_util.tree_flatten_with_path(cache)[0]}
    return {path: (t.numpy() if t.dtype in (torch.int32, torch.float32) else bridge.to_numpy(t))
            for path, t in tree_items(cache)}


def _assert_caches_agree(got, want):
    """int leaves bitwise; K/V where the sibling ``slot_pos`` holds a position; the
    other float leaves (SSM state, conv buffer) everywhere."""
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        w = want[path]
        assert g.shape == w.shape, path
        if w.dtype == np.int32:
            np.testing.assert_array_equal(g, w, err_msg=path)
            continue
        g, w = g.astype(np.float32), w.astype(np.float32)
        head, _, leaf = path.rpartition("/")
        if leaf in ("k", "v") and f"{head}/slot_pos" in want:
            live = want[f"{head}/slot_pos"] >= 0
            assert live.any() and (~live).any(), path
            g, w = g[live], w[live]
        np.testing.assert_allclose(g, w, err_msg=path, **CACHE_TOL)


@pytest.mark.parametrize("arch", list(CASES))
def test_bucketed_batcher_equals_padded_batcher(arch, monkeypatch):
    cache_len, lens = CASES[arch]
    if arch == "hymba-1.5b":
        api = build(get_smoke(arch).replace(dtype="float32"), device="cpu")
        params = api.init_params(torch.Generator().manual_seed(0))
    else:
        japi, jparams, api, params = _models(arch)
    prompts = _prompts(lens, api.cfg.vocab_size)
    got, batcher = _serve(ContinuousBatcher, Request, api, params, cache_len, prompts)
    if arch == "hymba-1.5b":
        monkeypatch.setattr(batching, "prefill_length", lambda n, room, cfg: room)
        want, ref = _serve(ContinuousBatcher, Request, api, params, cache_len, prompts)
        monkeypatch.undo()
        ref_cache, steps = _flat_numpy(ref.cache, False), ref.steps
        assert ref.prefill_positions == cache_len * len(prompts)
    else:
        want, ref = _serve(JaxBatcher, JaxRequest, japi, jparams, cache_len, prompts)
        ref_cache, steps = _flat_numpy(ref.cache, True), ref._steps
    assert got == want
    assert all(len(t) == MAX_NEW for t in got.values())
    assert batcher.steps == steps
    # the buckets engaged: fewer positions than padding every prompt to the cache
    assert batcher.prefill_positions < cache_len * len(prompts)
    _assert_caches_agree(_flat_numpy(batcher.cache, False), ref_cache)


def test_short_prompt_after_long_one_leaves_no_stale_position():
    """One slot serves a 600-token prompt, then a 5-token one prefilled at 256: past
    the short prompt the slot holds no valid position of the long one, and the short
    request's tokens and ``slot_pos`` are those of a batcher that served it alone."""
    api = build(get_smoke("granite-8b").replace(dtype="float32"), device="cpu")
    params = api.init_params(torch.Generator().manual_seed(3))
    long, short = _prompts([600, 5], api.cfg.vocab_size)
    batcher = ContinuousBatcher(api, params, num_slots=1, cache_len=640)
    batcher.submit(Request(0, long, max_new_tokens=2))
    batcher.run_to_completion()
    assert (batcher.cache["attn"]["slot_pos"][:, 0] >= 0).sum(dim=-1).tolist() == [601] * 2
    req = Request(1, short, max_new_tokens=3)
    batcher.submit(req)
    batcher.step()      # admits the short request (positions 0-4) and decodes position 5
    for layer in batcher.cache["attn"]["slot_pos"][:, 0]:
        assert torch.nonzero(layer >= 0).flatten().tolist() == list(range(6))
        assert layer[:6].tolist() == list(range(6))
    batcher.run_to_completion()
    alone = ContinuousBatcher(api, params, num_slots=1, cache_len=640)
    alone.submit(Request(1, short, max_new_tokens=3))
    assert alone.run_to_completion()[1] == req.generated
    assert torch.equal(alone.cache["attn"]["slot_pos"], batcher.cache["attn"]["slot_pos"])


def test_prefill_counters():
    """The prompt tokens prefilled (a prompt cut to the room counts what is kept) and
    the positions the prefills were handed."""
    api = build(get_smoke("granite-8b").replace(dtype="float32"), device="cpu")
    params = api.init_params(torch.Generator().manual_seed(4))
    batcher = ContinuousBatcher(api, params, num_slots=2, cache_len=320)
    assert (batcher.prefill_prompt_tokens, batcher.prefill_positions) == (0, 0)
    for rid, prompt in enumerate(_prompts([5, 300, 9, 400], api.cfg.vocab_size)):
        batcher.submit(Request(rid, prompt, max_new_tokens=2))
    batcher.run_to_completion()
    assert batcher.prefill_prompt_tokens == 5 + 300 + 9 + 320
    assert batcher.prefill_positions == 256 + 320 + 256 + 320
