"""The port's vlm family (internvl2-76b smoke) against the JAX package's.

A vlm is a dense LM whose sequence starts with a request's P patch
embeddings, projected by ``patch_proj``. The port follows the reference's
prefill (logits, K/V and slot positions), but its cache ``pos`` is P + plen,
the position of the next token, where the reference's is plen; and its
batcher pads the text to cache_len - P, where the reference's pads it to
cache_len and cannot write the prefill cache into its slot. Both faults of
the reference are pinned here (ROADMAP.md C).

Weights come from ``repro``'s ``init_params`` and are carried across by
``repro_torch.bridge``; tokens and patches come from numpy seeds.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.models.model import build as jax_build  # noqa: E402
from repro.serving.batching import ContinuousBatcher as JaxBatcher  # noqa: E402
from repro.serving.batching import Request as JaxRequest  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.common import tree_items  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.serving.batching import ContinuousBatcher, Request  # noqa: E402
from repro_torch.serving.engine import generate  # noqa: E402

ARCH = "internvl2-76b"
TOL = {"float32": dict(rtol=2e-3, atol=2e-3),
       "bfloat16": dict(rtol=5e-2, atol=5e-1)}   # tests/test_serving.py:48
P = 8                                             # the smoke config's num_patches


def _models(dtype):
    japi = jax_build(jax_get_smoke(ARCH).replace(dtype=dtype))
    jparams = japi.init_params(jax.random.PRNGKey(0))
    api = build(get_smoke(ARCH).replace(dtype=dtype), device="cpu")
    params = bridge.from_numpy_tree(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return japi, jparams, api, params


@pytest.fixture(scope="module")
def f32():
    return _models("float32")


def _patches(seed, b=1, dtype="float32"):
    """[b, P, d_model] patch embeddings from a numpy seed, as (jax, torch)."""
    arr = np.random.default_rng(seed).standard_normal((b, P, 128)).astype(np.float32)
    j = jnp.asarray(arr, dtype)
    return j, bridge.to_tensor(np.asarray(j), "cpu")


def test_template_adds_patch_proj_and_counts_it(f32):
    _, jparams, api, params = f32
    assert tuple(params["patch_proj"].shape) == (128, 128)
    assert api.param_count() == api.cfg.num_params()
    assert sorted(p for p, _ in tree_items(params)) == sorted(
        "/".join(str(k.key) for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(jparams)[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches_the_reference(dtype):
    """Logits and the cache's k, v and slot_pos (P + S slots, the first P + plen
    valid) equal the reference's; pos is P + plen, where the reference's is plen."""
    japi, jparams, api, params = _models(dtype)
    rng = np.random.default_rng(3)
    B, S = 2, 16
    tokens = rng.integers(0, api.cfg.vocab_size, size=(B, S)).astype(np.int32)
    plens = np.array([S, 11], np.int32)
    pj, pt = _patches(4, B, dtype)
    jl, jc = jax.jit(lambda p, t, l, x: japi.prefill(p, t, l, patches=x))(jparams, tokens, plens, pj)
    tl, tc = api.prefill(params, torch.from_numpy(tokens), torch.from_numpy(plens), patches=pt)
    np.testing.assert_allclose(bridge.to_numpy(tl), np.asarray(jl), **TOL[dtype])
    for leaf in ("k", "v"):
        assert str(tc["attn"][leaf].dtype).removeprefix("torch.") == np.asarray(jc["attn"][leaf]).dtype.name
        np.testing.assert_allclose(bridge.to_numpy(tc["attn"][leaf]),
                                   np.asarray(jc["attn"][leaf], np.float32), **TOL[dtype])
    np.testing.assert_array_equal(tc["attn"]["slot_pos"].numpy(), np.asarray(jc["attn"]["slot_pos"]))
    assert tc["attn"]["slot_pos"].shape[-1] == P + S
    np.testing.assert_array_equal(tc["pos"].numpy(), P + plens)
    np.testing.assert_array_equal(np.asarray(jc["pos"]), plens)


def test_decode_matches_the_reference_at_the_right_position(f32):
    """The port's decode step equals the reference's once the reference's cache
    is given the right position, P + plen."""
    japi, jparams, api, params = f32
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, api.cfg.vocab_size, size=(2, 17)).astype(np.int32)
    plens = np.array([16, 9], np.int32)
    pj, pt = _patches(6, 2)
    _, jc = jax.jit(lambda p, t, l, x: japi.prefill(p, t, l, patches=x))(jparams, tokens[:, :16], plens, pj)
    _, tc = api.prefill(params, torch.from_numpy(tokens[:, :16]), torch.from_numpy(plens), patches=pt)
    nxt = tokens[np.arange(2), plens]
    jd, jc = jax.jit(japi.decode_step)(jparams, {**jc, "pos": jc["pos"] + P}, nxt)
    td, tc = api.decode_step(params, tc, torch.from_numpy(nxt))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL["float32"])
    np.testing.assert_array_equal(tc["attn"]["slot_pos"].numpy(), np.asarray(jc["attn"]["slot_pos"]))
    np.testing.assert_array_equal(tc["pos"].numpy(), P + plens + 1)


# -------------------------------------- prefill then decode = the longer prefill
FAULT_S, FAULT_N = 32, 10


@pytest.fixture(scope="module")
def fault_inputs(f32):
    """tokens [1, 33] from numpy seed 1 and patches of 0.1, as ROADMAP.md C names them."""
    tokens = np.random.default_rng(1).integers(0, 512, size=(1, FAULT_S + 1)).astype(np.int32)
    return tokens, np.full((1, P, 128), 0.1, np.float32)


def _padded(tokens, n):
    t = np.zeros((1, FAULT_S), np.int32)
    t[0, :n] = tokens[0, :n]
    return t


def _step_vs_full(prefill, decode, tokens, n):
    """max |logits of prefill(t[:n]) + decode_step(t[n]) - logits of prefill(t[:n+1])|."""
    full, _ = prefill(_padded(tokens, n + 1), n + 1)
    _, cache = prefill(_padded(tokens, n), n)
    step = decode(cache, tokens[:, n])
    return float(np.abs(np.asarray(full, np.float32) - np.asarray(step, np.float32)).max())


@pytest.mark.parametrize("n", [FAULT_N, 20])
def test_prefill_then_decode_equals_longer_prefill(f32, fault_inputs, n):
    _, _, api, params = f32
    tokens, patches = fault_inputs
    pt = torch.from_numpy(patches)
    prefill = lambda t, k: api.prefill(params, torch.from_numpy(t), torch.tensor([k], dtype=torch.int32),
                                       patches=pt)
    decode = lambda c, tok: api.decode_step(params, c, torch.from_numpy(tok))[0]
    assert _step_vs_full(prefill, decode, tokens, n) < 2e-3


def test_reference_vlm_decode_uses_the_text_position(f32, fault_inputs):
    """The reference's prefill sets pos = plen, not P + plen
    (repro/models/transformer.py:449): its first decode step rotates by and
    overwrites a position inside the prompt, and misses the longer prefill by
    1.23, against 2e-3 (ROADMAP.md C)."""
    japi, jparams, _, _ = f32
    tokens, patches = fault_inputs
    pf = jax.jit(lambda t, k: japi.prefill(jparams, t, k, patches=jnp.asarray(patches)))
    prefill = lambda t, k: pf(jnp.asarray(t), jnp.asarray([k], jnp.int32))
    jd = jax.jit(japi.decode_step)
    decode = lambda c, tok: jd(jparams, c, jnp.asarray(tok))[0]
    err = _step_vs_full(prefill, decode, tokens, FAULT_N)
    assert abs(err - 1.2299) < 1e-3
    # with the position put right, the reference agrees with itself
    fixed = lambda c, tok: jd(jparams, {**c, "pos": c["pos"] + P}, jnp.asarray(tok))[0]
    assert _step_vs_full(prefill, fixed, tokens, FAULT_N) < 2e-3


# ---------------------------------------------------------------- batcher
CACHE_LEN = 32
# the fourth prompt, 28 tokens, is cut to cache_len - P = 24 and fills the cache;
# the fifth's 20 tokens and 4 new ones fill all but one slot (a request that runs
# past the cache overwrites its last slot, which a longer prefill does not do)
REQUESTS = [([5, 9, 2, 7], 6), ([1, 2, 3], 6), ([11, 4, 8, 15, 16], 6),
            (list(range(3, 31)), 1), (list(range(40, 60)), 4)]


def _extras(rid):
    return {"patches": _patches(100 + rid)[1]}


def test_reference_batcher_cannot_serve_a_vlm(f32):
    """The reference's batcher pads the text to cache_len, so its prefill cache has
    cache_len + P slots and insert_slot cannot write it (ROADMAP.md C)."""
    japi, jparams, _, _ = f32
    batcher = JaxBatcher(japi, jparams, num_slots=2, cache_len=CACHE_LEN,
                         extras_fn=lambda rid: {"patches": _patches(100 + rid)[0]})
    batcher.submit(JaxRequest(0, [1, 2, 3], max_new_tokens=4))
    with pytest.raises(ValueError, match=r"\(2, 1, 40, 2, 16\).*\(2, 1, 32, 2, 16\)"):
        batcher.run_to_completion()


def test_batcher_equals_a_greedy_loop_of_reference_prefills(f32):
    """Each request's tokens from the port's batcher equal a greedy loop of the
    reference's prefill over the growing prompt (which the reference gets right),
    with the text cut to cache_len - P; and the launch counters stay at 0 on the CPU."""
    japi, jparams, api, params = f32
    ops.reset_launch_counts()
    batcher = ContinuousBatcher(api, params, num_slots=2, cache_len=CACHE_LEN, extras_fn=_extras)
    for rid, (prompt, n) in enumerate(REQUESTS):
        batcher.submit(Request(rid, prompt, max_new_tokens=n))
    got = batcher.run_to_completion()
    assert set(ops.launch_counts().values()) == {0}
    assert tuple(batcher.cache["attn"]["k"].shape[2:3]) == (CACHE_LEN,)
    pf = jax.jit(lambda t, k, x: japi.prefill(jparams, t, k, patches=x))
    room = CACHE_LEN - P
    for rid, (prompt, n) in enumerate(REQUESTS):
        seq, want = list(prompt[:room]), []
        for _ in range(n):
            t = np.zeros((1, room), np.int32)
            t[0, :len(seq)] = seq
            logits, _ = pf(jnp.asarray(t), jnp.asarray([len(seq)], jnp.int32), _patches(100 + rid)[0])
            want.append(int(jnp.argmax(logits[0])))
            seq.append(want[-1])
        assert got[rid] == want, f"request {rid}"


def test_generate_with_patches_equals_the_batcher(f32):
    _, _, api, params = f32
    prompt, n = REQUESTS[2]
    got = ContinuousBatcher(api, params, num_slots=1, cache_len=CACHE_LEN, extras_fn=_extras)
    got.submit(Request(2, prompt, max_new_tokens=n))
    toks = torch.tensor([prompt + [0] * (CACHE_LEN - P - len(prompt))], dtype=torch.int32)
    seq = generate(api, params, toks, torch.tensor([len(prompt)], dtype=torch.int32), n,
                   extras=_extras(2))
    assert seq[0].tolist() == got.run_to_completion()[2]


def test_prefill_without_patches_raises(f32):
    _, _, api, params = f32
    with pytest.raises(ValueError, match="patches"):
        api.prefill(params, torch.zeros((1, 8), dtype=torch.int32), torch.tensor([3], dtype=torch.int32))


def test_prefill_with_another_patch_count_raises(f32):
    """The batcher sizes a vlm's text by cfg.num_patches, so other counts are refused."""
    _, _, api, params = f32
    patches = torch.zeros((1, P + 1, 128), dtype=torch.float32)
    with pytest.raises(ValueError, match="num_patches"):
        api.prefill(params, torch.zeros((1, 8), dtype=torch.int32), torch.tensor([3], dtype=torch.int32),
                    patches=patches)
