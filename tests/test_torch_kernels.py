"""Port kernels' plain versions against the JAX package's Pallas kernels.

The same numpy-seeded inputs go through ``repro.kernels.ops`` (Pallas, in
interpret mode) and ``repro_torch.kernels.ops`` on CPU tensors (the plain
PyTorch versions), over the sweeps of ``tests/test_kernels.py``. The CUDA
kernels themselves run only on the card (``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.bridge import to_numpy, to_tensor  # noqa: E402
from repro_torch.kernels import decode_attention as kdec  # noqa: E402
from repro_torch.kernels import flash_attention as kfl  # noqa: E402
from repro_torch.kernels import moe_gmm as kgmm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rmsnorm as krms  # noqa: E402
from repro_torch.kernels import ssd as kssd  # noqa: E402

DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _tol(dtype):
    return dict(rtol=3e-2, atol=3e-2) if dtype == "bfloat16" else dict(rtol=2e-3, atol=2e-3)


def _pair(rng, shape, dtype):
    """One numpy-seeded array as a JAX array and a CPU tensor with the same bits."""
    j = jnp.asarray(rng.standard_normal(shape).astype(np.float32), DTYPES[dtype])
    return j, to_tensor(np.asarray(j), "cpu")


@pytest.fixture(autouse=True)
def _counters_stay_zero():
    """The plain path launches nothing: every counter stays at 0."""
    ops.reset_launch_counts()
    yield
    assert ops.launch_counts() == {"rmsnorm": 0, "flash_attention": 0, "decode_attention": 0,
                                   "moe_gmm": 0, "ssd": 0, "rmsnorm_backward": 0,
                                   "flash_attention_backward": 0, "moe_gmm_backward": 0,
                                   "ssd_backward": 0}


# ------------------------------------------------------------- rmsnorm
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 128), (2, 37, 64), (3, 5, 7, 32)])
def test_rmsnorm_plain_matches_pallas(shape, dtype):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng, shape, dtype)
    sj, st = _pair(rng, shape[-1:], dtype)
    want = jops.rmsnorm(xj, sj, interpret=True, use_pallas=True)
    got = ops.rmsnorm(xt, st)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    np.testing.assert_allclose(to_numpy(got), np.asarray(want, np.float32), **_tol(dtype))


# ------------------------------------------------------ flash attention
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk,hq,hkv,dh,causal,window", [
    (64, 64, 4, 2, 32, True, 0),
    (100, 100, 6, 2, 16, True, 0),     # non-multiple of block
    (128, 128, 8, 2, 64, True, 48),    # sliding window
    (64, 96, 4, 2, 32, False, 0),      # cross attention
    (32, 32, 4, 4, 16, True, 0),       # MHA
])
def test_flash_attention_plain_matches_pallas(sq, sk, hq, hkv, dh, causal, window, dtype):
    rng = np.random.default_rng(1)
    qj, qt = _pair(rng, (2, sq, hq, dh), dtype)
    kj, kt = _pair(rng, (2, sk, hkv, dh), dtype)
    vj, vt = _pair(rng, (2, sk, hkv, dh), dtype)
    want = jops.flash_attention(qj, kj, vj, causal=causal, window=window, q_block=32,
                                kv_block=32, interpret=True, use_pallas=True)
    got = ops.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    np.testing.assert_allclose(to_numpy(got), np.asarray(want, np.float32), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk,causal,window,q_offset", [
    (16, 16, True, 0, 0), (8, 24, True, 5, 16), (12, 20, False, 0, 0)])
def test_naive_attention_matches_jax(sq, sk, causal, window, q_offset, dtype):
    from repro.models.attention import naive_attention as jax_naive
    from repro_torch.models.attention import naive_attention

    rng = np.random.default_rng(4)
    qj, qt = _pair(rng, (2, sq, 6, 16), dtype)
    kj, kt = _pair(rng, (2, sk, 2, 16), dtype)
    vj, vt = _pair(rng, (2, sk, 2, 16), dtype)
    want = jax_naive(qj, kj, vj, causal=causal, window=window, q_offset=q_offset)
    got = naive_attention(qt, kt, vt, causal=causal, window=window, q_offset=q_offset)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want, np.float32), **_tol(dtype))


# ------------------------------------------------------ decode attention
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,hq,hkv,dh,window,fill", [
    (128, 8, 2, 64, 0, 128),
    (128, 8, 2, 64, 0, 77),
    (96, 4, 4, 32, 32, 96),
    (100, 6, 2, 16, 0, 50),
])
def test_decode_attention_plain_matches_pallas(s, hq, hkv, dh, window, fill, dtype):
    b = 2
    rng = np.random.default_rng(2)
    qj, qt = _pair(rng, (b, hq, dh), dtype)
    kj, kt = _pair(rng, (b, s, hkv, dh), dtype)
    vj, vt = _pair(rng, (b, s, hkv, dh), dtype)
    slot = np.where(np.arange(s)[None] < fill, np.arange(s)[None], -1)
    slot = np.broadcast_to(slot, (b, s)).astype(np.int32).copy()
    slot[1, 3] = -1  # a hole inside the filled range
    cur = np.array([fill, fill - 7], np.int32)
    want = jops.decode_attention(qj, kj, vj, jnp.asarray(slot), jnp.asarray(cur), window=window,
                                 kv_block=32, interpret=True, use_pallas=True)
    got = ops.decode_attention(qt, kt, vt, torch.from_numpy(slot), torch.from_numpy(cur),
                               window=window)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    np.testing.assert_allclose(to_numpy(got), np.asarray(want, np.float32), **_tol(dtype))


def test_decode_attention_f32_query_on_bf16_cache_matches_jax():
    """A float32 model's batched decode: float32 q against the bf16 cache. The
    JAX model's jnp decode attention computes this case (scores in float32,
    probabilities rounded to bf16 before PV, a bf16 result)."""
    from repro.models.attention import decode_attention as jax_decode

    b, s, hq, hkv, dh = 2, 64, 8, 2, 32
    rng = np.random.default_rng(6)
    qj, qt = _pair(rng, (b, hq, dh), "float32")
    kj, kt = _pair(rng, (b, s, hkv, dh), "bfloat16")
    vj, vt = _pair(rng, (b, s, hkv, dh), "bfloat16")
    slot = np.where(np.arange(s)[None] < 40, np.arange(s)[None], -1)
    slot = np.broadcast_to(slot, (b, s)).astype(np.int32).copy()
    cur = np.array([39, 30], np.int32)
    want = jax_decode(qj, kj, vj, jnp.asarray(slot), jnp.asarray(cur))
    got = ops.decode_attention(qt, kt, vt, torch.from_numpy(slot), torch.from_numpy(cur))
    assert got.dtype == torch.bfloat16 and np.asarray(want).dtype.name == "bfloat16"
    np.testing.assert_allclose(to_numpy(got), np.asarray(want, np.float32), **_tol("bfloat16"))


# -------------------------------------------------------------- moe gmm
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,c,d,f", [(4, 32, 64, 48), (8, 40, 100, 72)])
def test_moe_gmm_plain_matches_pallas(e, c, d, f, dtype):
    """tests/test_kernels.py:120's shapes (ragged C, D and F) and tolerances."""
    rng = np.random.default_rng(7)
    xj, xt = _pair(rng, (e, c, d), dtype)
    wj, wt = _pair(rng, (e, d, f), dtype)
    want = jops.moe_gmm(xj, wj, block_c=32, block_f=32, block_d=32, interpret=True,
                        use_pallas=True)
    got = ops.moe_gmm(xt, wt)
    assert got.dtype == xt.dtype and tuple(got.shape) == (e, c, f)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want, np.float32),
                               rtol=5e-2 if dtype == "bfloat16" else 1e-3,
                               atol=5e-1 if dtype == "bfloat16" else 1e-2)


# ------------------------------------------------------------------ ssd
def _ssd_inputs(rng, b, s, h, p, n, dtype="float32"):
    """tests/test_kernels.py::test_ssd_kernel's distributions: x, b, c ~ N(0, 0.25)
    in ``dtype``, a = -|N(0, 1)| * 0.3 in float32; as JAX arrays and CPU tensors."""
    def pair(shape, dt, fn):
        j = jnp.asarray(fn(rng.standard_normal(shape)).astype(np.float32), DTYPES[dt])
        return j, to_tensor(np.asarray(j), "cpu")
    return (pair((b, s, h, p), dtype, lambda v: v * 0.5), pair((b, s, h), "float32", lambda v: -np.abs(v) * 0.3),
            pair((b, s, n), dtype, lambda v: v * 0.5), pair((b, s, n), dtype, lambda v: v * 0.5))


@pytest.mark.parametrize("s,h,p,n,chunk", [
    (64, 3, 16, 8, 16),
    (128, 4, 32, 16, 32),
    (96, 2, 8, 4, 16),
])
def test_ssd_plain_matches_pallas(s, h, p, n, chunk):
    """tests/test_kernels.py:101-104's shapes and 1e-3 tolerance, through ``ops.ssd``."""
    (xj, xt), (aj, at), (bj, bt), (cj, ct) = _ssd_inputs(np.random.default_rng(8), 2, s, h, p, n)
    yj, hj = jops.ssd(xj, aj, bj, cj, chunk=chunk, interpret=True, use_pallas=True)
    y, hf = ops.ssd(xt, at, bt, ct, chunk=chunk)
    assert y.dtype == torch.float32 and tuple(y.shape) == (2, s, h, p)
    assert hf.dtype == torch.float32 and tuple(hf.shape) == (2, h, p, n)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(hf.numpy(), np.asarray(hj), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("s,chunk", [(32, 8), (64, 16), (64, 64)])
def test_ssd_plain_matches_sequential(s, chunk):
    """tests/test_ssm_moe.py:19-30: the chunked form against the O(S) recurrence, 1e-4."""
    (_, xt), (_, at), (_, bt), (_, ct) = _ssd_inputs(np.random.default_rng(9), 2, s, 3, 8, 4)
    y1, h1 = kssd.plain(xt, at, bt, ct, chunk)
    y2, h2 = kssd.sequential(xt, at, bt, ct)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(h1.numpy(), h2.numpy(), rtol=1e-4, atol=1e-4)
    # an initial state carries through both forms alike
    h0 = torch.from_numpy(np.random.default_rng(10).standard_normal(h1.shape).astype(np.float32))
    y3, h3 = kssd.plain(xt, at, bt, ct, chunk, h0)
    y4, h4 = kssd.sequential(xt, at, bt, ct, h0)
    np.testing.assert_allclose(y3.numpy(), y4.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(h3.numpy(), h4.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("s,h,p,n,chunk", [(64, 3, 16, 8, 16), (96, 2, 8, 4, 16)])
def test_ssd_plain_bf16_matches_jax(s, h, p, n, chunk):
    """bf16 x, b, c (a stays float32): y comes back bf16, the state float32."""
    from repro.kernels import ref as jref

    (xj, xt), (aj, at), (bj, bt), (cj, ct) = _ssd_inputs(np.random.default_rng(11), 2, s, h, p, n,
                                                         "bfloat16")
    yj, hj = jref.ssd(xj, aj, bj, cj, chunk)
    y, hf = ops.ssd(xt, at, bt, ct, chunk=chunk)
    assert y.dtype == torch.bfloat16 and hf.dtype == torch.float32
    assert np.asarray(yj).dtype.name == "bfloat16"
    np.testing.assert_allclose(to_numpy(y), np.asarray(yj, np.float32), **_tol("bfloat16"))
    np.testing.assert_allclose(hf.numpy(), np.asarray(hj), **_tol("bfloat16"))


# ------------------------------------------- the wrappers take CUDA only
@pytest.mark.parametrize("call", [
    lambda t: krms.rmsnorm(t(4, 32), t(32)),
    lambda t: kfl.flash_attention(t(1, 8, 4, 16), t(1, 8, 2, 16), t(1, 8, 2, 16)),
    lambda t: kdec.decode_attention(t(1, 4, 16), t(1, 8, 2, 16), t(1, 8, 2, 16),
                                    torch.zeros(1, 8, dtype=torch.int32),
                                    torch.zeros(1, dtype=torch.int32)),
    lambda t: kgmm.moe_gmm(t(2, 8, 16), t(2, 16, 24)),
    lambda t: kssd.ssd(t(1, 16, 2, 8), t(1, 16, 2), t(1, 16, 4), t(1, 16, 4), chunk=16),
], ids=["rmsnorm", "flash_attention", "decode_attention", "moe_gmm", "ssd"])
def test_kernel_wrappers_refuse_cpu_tensors(call):
    """A kernel wrapper never falls back to the plain version: a CPU tensor raises."""
    with pytest.raises(ValueError, match="CUDA"):
        call(lambda *shape: torch.zeros(shape))
