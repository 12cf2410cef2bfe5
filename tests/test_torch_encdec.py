"""The port's encdec family (whisper-base smoke) against the JAX package's.

Whisper's layers (``layer_norm``, ``gelu_mlp``, ``sinusoidal_positions``),
its attention modes (flash non-causal with Sq != Sk, decode over an
all-valid cross cache) against the Pallas kernels in interpret mode, the
encoder, prefill (logits and the whole cache tree) and decode step against
``repro.models.encdec``, and the port's batcher against the reference's
with frames of ``encoder_frames``, one request decoding past its cache. A
frame count other than ``encoder_frames`` is refused by the port's prefill;
the reference's batcher fails on it later (ROADMAP.md C).

Weights come from ``repro``'s ``init_params`` and are carried across by
``repro_torch.bridge``; tokens and frames come from numpy seeds.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import encdec as jax_encdec  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models.model import build as jax_build  # noqa: E402
from repro.serving.batching import ContinuousBatcher as JaxBatcher  # noqa: E402
from repro.serving.batching import Request as JaxRequest  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import encdec, layers  # noqa: E402
from repro_torch.models.common import init_params, tree_items  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.serving.batching import ContinuousBatcher, Request  # noqa: E402
from repro_torch.serving.engine import generate  # noqa: E402

ARCH = "whisper-base"
TOL = {"float32": dict(rtol=2e-3, atol=2e-3),
       "bfloat16": dict(rtol=5e-2, atol=5e-1)}   # tests/test_serving.py:48
KERNEL_TOL = {"float32": dict(rtol=2e-3, atol=2e-3),
              "bfloat16": dict(rtol=3e-2, atol=3e-2)}   # tests/test_kernels.py::_tol
F, D = 32, 64                                    # the smoke config's encoder_frames, d_model


def _models(dtype):
    japi = jax_build(jax_get_smoke(ARCH).replace(dtype=dtype))
    jparams = japi.init_params(jax.random.PRNGKey(0))
    api = build(get_smoke(ARCH).replace(dtype=dtype), device="cpu")
    params = bridge.from_numpy_tree(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return japi, jparams, api, params


@pytest.fixture(scope="module")
def f32():
    return _models("float32")


def _pair(arr, dtype="float32"):
    j = jnp.asarray(arr, dtype)
    return j, bridge.to_tensor(np.asarray(j), "cpu")


def _frames(seed, b=1, dtype="float32", f=F):
    return _pair(np.random.default_rng(seed).standard_normal((b, f, D)).astype(np.float32), dtype)


def _jax_paths(tree):
    """``/``-joined paths of a JAX tree: dict keys and list indices."""
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", None))) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_tree_close(ttree, jtree, tol):
    jflat, tflat = _jax_paths(jtree), dict(tree_items(ttree))
    assert sorted(jflat) == sorted(tflat)
    for path, t in tflat.items():
        want = np.asarray(jflat[path])
        assert str(t.dtype).removeprefix("torch.") == want.dtype.name, path
        if want.dtype == np.int32:
            np.testing.assert_array_equal(t.numpy(), want, err_msg=path)
        else:
            np.testing.assert_allclose(bridge.to_numpy(t), want.astype(np.float32), err_msg=path,
                                       **tol)


# ---------------------------------------------------------------- layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_and_gelu_mlp_match_the_reference(dtype):
    rng = np.random.default_rng(0)
    x = _pair(rng.standard_normal((2, 5, D)).astype(np.float32) * 3 + 1, dtype)
    scale, bias = (_pair(rng.standard_normal(D).astype(np.float32), dtype) for _ in range(2))
    want = jax_layers.layer_norm(x[0], scale[0], bias[0], 1e-5)
    got = layers.layer_norm(x[1], scale[1], bias[1], 1e-5)
    assert got.dtype == x[1].dtype
    np.testing.assert_allclose(bridge.to_numpy(got), np.asarray(want, np.float32), **KERNEL_TOL[dtype])
    w_in, w_out = (_pair(rng.standard_normal(s).astype(np.float32) * 0.2, dtype)
                   for s in ((D, 96), (96, D)))
    b_in, b_out = (_pair(rng.standard_normal(n).astype(np.float32), dtype) for n in (96, D))
    want = jax_layers.gelu_mlp(x[0], w_in[0], b_in[0], w_out[0], b_out[0])
    got = layers.gelu_mlp(x[1], w_in[1], b_in[1], w_out[1], b_out[1])
    assert got.dtype == x[1].dtype
    np.testing.assert_allclose(bridge.to_numpy(got), np.asarray(want, np.float32), **KERNEL_TOL[dtype])


@pytest.mark.parametrize("length,d", [(1, 8), (32, 64), (1500, 512)])
def test_sinusoidal_positions_match_the_reference(length, d):
    got = layers.sinusoidal_positions(length, d)
    assert got.dtype == torch.float32 and tuple(got.shape) == (length, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_layers.sinusoidal_positions(length, d)),
                               rtol=1e-5, atol=2e-5)


# ------------------------------------------------------ attention modes
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk", [(24, 32), (48, 32), (32, 32)])
def test_flash_plain_non_causal_matches_pallas(sq, sk, dtype):
    """Whisper's encoder (Sq = Sk) and cross-attention (Sq != Sk both ways), G = 1."""
    rng = np.random.default_rng(1)
    q, k, v = (_pair(rng.standard_normal((2, s, 4, 16)).astype(np.float32), dtype)
               for s in (sq, sk, sk))
    want = jops.flash_attention(q[0], k[0], v[0], causal=False, q_block=16, kv_block=16,
                                interpret=True, use_pallas=True)
    got = ops.flash_attention(q[1], k[1], v[1], causal=False)
    np.testing.assert_allclose(bridge.to_numpy(got), np.asarray(want, np.float32), **KERNEL_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_over_a_cross_cache_matches_pallas(dtype):
    """An all-valid cache: slot_pos 0 everywhere, cur_pos 0 (repro/models/encdec.py:214-216)."""
    rng = np.random.default_rng(2)
    q = _pair(rng.standard_normal((3, 4, 16)).astype(np.float32), dtype)
    k, v = (_pair(rng.standard_normal((3, F, 4, 16)).astype(np.float32), dtype) for _ in range(2))
    sp, cur = np.zeros((3, F), np.int32), np.zeros((3,), np.int32)
    want = jops.decode_attention(q[0], k[0], v[0], jnp.asarray(sp), jnp.asarray(cur), kv_block=16,
                                 interpret=True, use_pallas=True)
    got = ops.decode_attention(q[1], k[1], v[1], torch.from_numpy(sp), torch.from_numpy(cur))
    np.testing.assert_allclose(bridge.to_numpy(got), np.asarray(want, np.float32), **KERNEL_TOL[dtype])


# ---------------------------------------------------------------- model
def test_template_tree_init_and_bridge_walk_the_block_lists(f32):
    """The encdec tree holds lists (enc_blocks, dec_blocks): the port's template,
    init_params and bridge keep them, leaf for leaf with the reference's paths, and
    init_params draws each leaf from its own path."""
    _, jparams, api, params = f32
    jflat = _jax_paths(jparams)
    assert isinstance(params["dec_blocks"], list) and len(params["dec_blocks"]) == 2
    assert {p: tuple(s.shape) for p, s in tree_items(api.param_template)} == \
        {p: a.shape for p, a in jflat.items()}
    for path, t in tree_items(params):
        np.testing.assert_array_equal(t.numpy(), np.asarray(jflat[path]), err_msg=path)
    back = bridge.from_numpy_tree(jax.tree_util.tree_map(bridge.to_numpy, params), "cpu")
    assert [p for p, _ in tree_items(back)] == [p for p, _ in tree_items(params)]
    mine = init_params(api.param_template, torch.Generator().manual_seed(0), "cpu")
    assert isinstance(mine["enc_blocks"], list)
    wq = [mine["dec_blocks"][i]["self_attn"]["wq"] for i in range(2)] + [
        mine["dec_blocks"][0]["cross_attn"]["wq"], mine["enc_blocks"][0]["attn"]["wq"]]
    assert all(not torch.equal(a, b) for i, a in enumerate(wq) for b in wq[i + 1:])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_prefill_and_decode_match_the_reference(dtype):
    japi, jparams, api, params = _models(dtype)
    jcfg = japi.cfg
    rng = np.random.default_rng(3)
    B, S = 2, 16
    tokens = rng.integers(0, api.cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    plens = np.array([S, 11], np.int32)
    fj, ft = _frames(4, B, dtype)
    want = jax.jit(lambda p, x: jax_encdec.encode(p, x, jcfg))(jparams, fj)
    np.testing.assert_allclose(bridge.to_numpy(encdec.encode(params, ft, api.cfg)),
                               np.asarray(want, np.float32), **TOL[dtype])

    jl, jc = jax.jit(lambda p, t, l, x: japi.prefill(p, t, l, frames=x))(jparams, tokens[:, :S], plens, fj)
    tl, tc = api.prefill(params, torch.from_numpy(tokens[:, :S]), torch.from_numpy(plens), frames=ft)
    np.testing.assert_allclose(bridge.to_numpy(tl), np.asarray(jl), **TOL[dtype])
    _assert_tree_close(tc, jc, TOL[dtype])

    nxt = tokens[np.arange(B), plens]
    jd, jc = jax.jit(japi.decode_step)(jparams, jc, jnp.asarray(nxt))
    td, tc = api.decode_step(params, tc, torch.from_numpy(nxt))
    np.testing.assert_allclose(bridge.to_numpy(td), np.asarray(jd), **TOL[dtype])
    _assert_tree_close(tc, jc, TOL[dtype])


@pytest.mark.parametrize("batch,cache_len", [(1, 8), (3, 24)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_has_the_models_dtype_as_in_the_reference(dtype, batch, cache_len):
    jcache = jax_build(jax_get_smoke(ARCH).replace(dtype=dtype)).init_cache(batch, cache_len)
    tcache = build(get_smoke(ARCH).replace(dtype=dtype), device="cpu").init_cache(batch, cache_len)
    _assert_tree_close(tcache, jcache, dict(rtol=0, atol=0))
    assert tcache["cross"]["k"].dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]


def test_prefill_then_decode_equals_longer_prefill(f32):
    _, _, api, params = f32
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, api.cfg.vocab_size, size=(1, 25)).astype(np.int32)
    _, ft = _frames(7)
    for n in (10, 23):
        t = torch.from_numpy(tokens[:, :24].copy())
        t[0, n:] = 0
        _, cache = api.prefill(params, t, torch.tensor([n], dtype=torch.int32), frames=ft)
        step, _ = api.decode_step(params, cache, torch.from_numpy(tokens[:, n]))
        t[0, n] = int(tokens[0, n])
        full, _ = api.prefill(params, t, torch.tensor([n + 1], dtype=torch.int32), frames=ft)
        assert (step - full).abs().max().item() < 2e-3


def test_prefill_refuses_frames_of_another_length(f32):
    _, _, api, params = f32
    tokens, plens = torch.zeros((1, 8), dtype=torch.int32), torch.tensor([3], dtype=torch.int32)
    with pytest.raises(ValueError, match="encoder_frames"):
        api.prefill(params, tokens, plens, frames=_frames(0, f=16)[1])
    with pytest.raises(ValueError, match="frames"):
        api.prefill(params, tokens, plens)


def test_reference_batcher_fails_on_frames_of_another_length(f32):
    """examples/serve_lm.py --arch whisper-base hands 16 frames to a smoke model whose
    cross cache holds encoder_frames = 32: the reference's batcher fails in insert_slot."""
    japi, jparams, _, _ = f32
    batcher = JaxBatcher(japi, jparams, num_slots=2, cache_len=32,
                         extras_fn=lambda rid: {"frames": jnp.zeros((1, 16, D), jnp.float32)})
    batcher.submit(JaxRequest(0, [1, 2, 3], max_new_tokens=4))
    with pytest.raises(ValueError, match=r"\(2, 1, 16, 4, 16\).*\(2, 1, 32, 4, 16\)"):
        batcher.run_to_completion()


# ---------------------------------------------------------------- batcher
CACHE_LEN = 24
# the fourth request's 20 prompt tokens + 10 new ones run past the cache: its
# self-attention overwrites slot min(pos, S-1) and its position row is clamped
REQUESTS = [([5, 9, 2, 7], 6), ([1, 2, 3], 6), ([11, 4, 8, 15, 16], 6),
            (list(range(3, 23)), 10)]


def _run(batcher_cls, request_cls, api, params, frames):
    batcher = batcher_cls(api, params, num_slots=2, cache_len=CACHE_LEN,
                          extras_fn=lambda rid: {"frames": frames[rid]})
    for rid, (prompt, n) in enumerate(REQUESTS):
        batcher.submit(request_cls(rid, prompt, max_new_tokens=n))
    return batcher.run_to_completion(), batcher


def test_batcher_token_streams_equal_jax(f32):
    japi, jparams, api, params = f32
    frames = [_frames(200 + rid) for rid in range(len(REQUESTS))]
    want, jbatcher = _run(JaxBatcher, JaxRequest, japi, jparams, [f[0] for f in frames])
    ops.reset_launch_counts()
    got, batcher = _run(ContinuousBatcher, Request, api, params, [f[1] for f in frames])
    assert set(ops.launch_counts().values()) == {0}
    assert got == want
    assert all(len(got[rid]) == n for rid, (_, n) in enumerate(REQUESTS))
    assert batcher.steps == jbatcher._steps
    _assert_tree_close(batcher.cache, jbatcher.cache, TOL["float32"])


def test_generate_with_frames_equals_the_batcher(f32):
    _, _, api, params = f32
    frames = [_frames(200 + rid)[1] for rid in range(len(REQUESTS))]
    got, _ = _run(ContinuousBatcher, Request, api, params, frames)
    for rid, (prompt, n) in enumerate(REQUESTS[:3]):
        toks = torch.tensor([prompt + [0] * (CACHE_LEN - len(prompt))], dtype=torch.int32)
        seq = generate(api, params, toks, torch.tensor([len(prompt)], dtype=torch.int32), n,
                       extras={"frames": frames[rid]})
        assert seq[0].tolist() == got[rid], f"request {rid}"
