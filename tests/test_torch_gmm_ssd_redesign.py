"""Host side of the redesigned ``moe_gmm`` and ``ssd`` kernels, on the CPU.

``moe_gmm`` takes ``live`` [E, G], the leading rows of each group's block that
may be non-zero: its plain version is held against the JAX package's Pallas
kernel (interpret mode) on rows masked past ``live``, the MoE layer's two
dispatches are checked to hand it exactly their non-zero leading rows, and the
bf16 kernel's tile plan against the tiles the source instantiates. The ``ssd``
kernel is chunk-parallel: ``chunked_reference`` (its three passes in float32
PyTorch, with its workspaces) is held against the Pallas ``ssd`` and the O(S)
recurrence. And the library cache key covers the shared headers.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.bridge import to_numpy, to_tensor  # noqa: E402
from repro_torch.config import ModelConfig  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import moe_gmm as kgmm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd as kssd  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.common import init_params  # noqa: E402

DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
SMS = 132  # streaming multiprocessors of an H100 SXM


def _pair(rng, shape, dtype, scale=1.0):
    j = jnp.asarray((rng.standard_normal(shape) * scale).astype(np.float32), DTYPES[dtype])
    return j, to_tensor(np.asarray(j), "cpu")


@pytest.fixture(autouse=True)
def _counters_stay_zero():
    """The plain path launches nothing."""
    ops.reset_launch_counts()
    yield
    assert not any(ops.launch_counts().values())


# --------------------------------------------------------------- moe_gmm: live rows
def _live(rng, e, g, c):
    """int32 [E, G] counts in [0, C], with a 0 and a C among them."""
    live = rng.integers(0, c + 1, size=(e, g)).astype(np.int32)
    live[0, 0], live[-1, -1] = 0, c
    return live


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("e,c,d,f", [(4, 32, 64, 48), (8, 40, 100, 72)])
def test_plain_with_live_matches_pallas_on_masked_rows(e, c, d, f, groups, dtype):
    """tests/test_kernels.py:120's ragged shapes and tolerances: plain(xe, we, live)
    equals the Pallas kernel on xe whose rows past live are zero, whatever xe holds
    there; ``ops.moe_gmm`` takes the plain version on the CPU."""
    rng = np.random.default_rng(3)
    xj, xt = _pair(rng, (e, c, d), dtype)
    wj, wt = _pair(rng, (e, d, f), dtype)
    live = _live(rng, e, groups, c // groups)
    mask = to_numpy(kgmm.live_rows(torch.from_numpy(live), c))
    assert mask.shape == (e, c) and mask.sum() == live.sum()
    want = jops.moe_gmm(xj * jnp.asarray(mask[..., None], xj.dtype), wj, block_c=32, block_f=32,
                        block_d=32, interpret=True, use_pallas=True)
    got = ops.moe_gmm(xt, wt, torch.from_numpy(live))
    assert got.dtype == xt.dtype and tuple(got.shape) == (e, c, f)
    tol = dict(rtol=5e-2, atol=5e-1) if dtype == "bfloat16" else dict(rtol=1e-3, atol=1e-2)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want, np.float32), **tol)
    assert (to_numpy(got)[~mask] == 0).all()  # rows past live come back as zero


def test_live_rows_counts_leading_rows_of_each_group():
    live = torch.tensor([[0, 3], [2, 0]], dtype=torch.int32)
    want = [[0, 0, 0, 1, 1, 1], [1, 1, 0, 0, 0, 0]]
    assert kgmm.live_rows(live, 6).int().tolist() == want


def _moe_cfg(factor):
    return ModelConfig(name="t", family="moe", num_layers=1, d_model=16, num_heads=2,
                       num_kv_heads=2, d_ff=24, vocab_size=64, num_experts=8, experts_per_token=2,
                       moe_capacity_factor=factor)


@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
@pytest.mark.parametrize("factor", [8.0, 1.0, 0.25])
def test_moe_layer_hands_the_kernel_its_non_zero_leading_rows(dispatch, factor, monkeypatch):
    """Both dispatches, 4 routing groups, with and without drops (factor 0.25 leaves
    most experts over capacity): every ``moe_gmm`` call's live [E, G] is the number of
    rows filled at the head of each group's block, and every row past it is zero."""
    cfg = _moe_cfg(factor)
    params = init_params(moe.param_template(cfg), torch.Generator().manual_seed(0), "cpu",
                         "float32")
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 64, 16)).astype(np.float32))
    calls, real = [], ops.moe_gmm

    def spy(xe, we, live=None):
        calls.append((xe, live))
        return real(xe, we, live)

    monkeypatch.setattr(ops, "moe_gmm", spy)
    moe.apply_moe(x, params, cfg, dispatch=dispatch, group_size=32)
    cap = moe.expert_capacity(cfg, 32)
    assert len(calls) == 3
    for i, (xe, live) in enumerate(calls):
        e, rows, _ = xe.shape
        assert live.dtype == torch.int32 and tuple(live.shape) == (e, 4) and rows == 4 * cap
        assert int(live.max()) <= cap
        nonzero = (xe != 0).any(dim=-1).reshape(e, 4, cap)
        within = torch.arange(cap)
        past = within >= live[..., None]
        assert not nonzero[past].any()               # past live: zero
        if i < 2:                                    # gate and up: the dispatched rows
            assert nonzero[~past].all()
    if factor < 1.0:                                 # drops: some expert filled to capacity
        assert int(calls[0][1].max()) == cap


def test_both_dispatches_pass_the_same_live_counts(monkeypatch):
    cfg = _moe_cfg(0.5)
    params = init_params(moe.param_template(cfg), torch.Generator().manual_seed(1), "cpu",
                         "float32")
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((3, 8, 16)).astype(np.float32))
    seen, real = {}, ops.moe_gmm
    for dispatch in ("einsum", "sort"):
        lives = seen.setdefault(dispatch, [])

        def spy(xe, we, live=None, lives=lives):
            lives.append(live)
            return real(xe, we, live)

        monkeypatch.setattr(ops, "moe_gmm", spy)
        moe.apply_moe(x, params, cfg, dispatch=dispatch, group_size=8)
    assert all(torch.equal(a, b) for a, b in zip(seen["einsum"], seen["sort"]))


# -------------------------------------------------------- moe_gmm: kernel choice and tiles
def _instantiated_tiles():
    src = (_build.CSRC / "moe_gmm.cu").read_text()
    pattern = r"case (\d+) \* 16 \+ (\d+): return wg::launch<\1, \2>"
    return {(int(a), int(b)) for a, b in re.findall(pattern, src)}


def test_kernel_for_picks_the_tensor_core_kernel_for_bf16():
    assert kgmm.kernel_for(torch.bfloat16) == "moe_gmm_bf16"
    assert kgmm.kernel_for(torch.float32) == "moe_gmm_f32"
    src = (_build.CSRC / "moe_gmm.cu").read_text()
    for n in (8, 80):  # the products the tiles use, A transposed (the weights, MN-major)
        assert f"wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16" in src
    assert src.count("p, 1, 1, 1, 0;") == 2
    bf16 = src[src.index('extern "C" int moe_gmm_bf16('):]
    assert "wg::launch<" in bf16 and "simt::launch(" in src[src.index('extern "C" int moe_gmm_f32('):]


@pytest.mark.parametrize("rows", [1, 7, 8, 9, 16, 17, 32, 40, 64, 80, 81, 150, 160, 161, 240, 241,
                                  300, 600, 1280])
def test_tile_plan_is_instantiated_and_covers_every_row_once(rows):
    ni, ns = kgmm.tile_plan(rows)
    assert (ni, ns) in _instantiated_tiles()
    tile = ni * ns
    assert tile <= kgmm.MAX_BLOCK_ROWS
    tiles = -(-rows // tile)
    owner = np.zeros(rows, int)
    for t in range(tiles):
        owner[t * tile:min(rows, (t + 1) * tile)] += 1
    assert (owner == 1).all()
    if rows <= kgmm.MAX_BLOCK_ROWS:  # one row tile: each weight element read once a call
        assert tiles == 1               # (products wholly past the rows hold no live row: skipped)


@pytest.mark.parametrize("e,rows,f", [(64, 8, 1024), (64, 8, 2048), (64, 160, 1024),
                                      (64, 160, 2048), (128, 8, 1536), (128, 160, 1536)])
def test_tile_plan_fills_the_card_at_the_served_shapes(e, rows, f):
    """olmoe-1b-7b's (and qwen3-moe's) expert products at decode (C = 8) and prefill
    (C = 160): at least one block per SM."""
    ni, ns = kgmm.tile_plan(rows)
    blocks = e * -(-f // kgmm.BLOCK_COLS) * -(-rows // (ni * ns))
    assert blocks >= SMS


# ------------------------------------------------------------------- ssd: three passes
def _ssd_inputs(rng, b, s, h, p, n, dtype="float32"):
    """tests/test_kernels.py::test_ssd_kernel's distributions, as JAX arrays and tensors."""
    def pair(shape, dt, fn):
        j = jnp.asarray(fn(rng.standard_normal(shape)).astype(np.float32), DTYPES[dt])
        return j, to_tensor(np.asarray(j), "cpu")
    return (pair((b, s, h, p), dtype, lambda v: v * 0.5),
            pair((b, s, h), "float32", lambda v: -np.abs(v) * 0.3),
            pair((b, s, n), dtype, lambda v: v * 0.5), pair((b, s, n), dtype, lambda v: v * 0.5))


# tests/test_kernels.py:101-104's shapes (B = 2), one chunk (B = 1), and P, N not multiples of 4
SSD_CASES = [(2, 64, 3, 16, 8, 16), (2, 128, 4, 32, 16, 32), (2, 96, 2, 8, 4, 16),
             (1, 32, 2, 16, 8, 64), (2, 64, 3, 5, 7, 32)]


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_CASES)
def test_chunked_reference_matches_pallas_and_sequential(b, s, h, p, n, chunk):
    (xj, xt), (aj, at), (bj, bt), (cj, ct) = _ssd_inputs(np.random.default_rng(12), b, s, h, p, n)
    y, hf = kssd.chunked_reference(xt, at, bt, ct, chunk)
    yj, hj = jops.ssd(xj, aj, bj, cj, chunk=min(chunk, s), interpret=True, use_pallas=True)
    assert y.dtype == torch.float32 and tuple(y.shape) == (b, s, h, p)
    assert hf.dtype == torch.float32 and tuple(hf.shape) == (b, h, p, n)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(hf.numpy(), np.asarray(hj), rtol=1e-3, atol=1e-3)
    y2, h2 = kssd.sequential(xt, at, bt, ct)
    np.testing.assert_allclose(y.numpy(), y2.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(hf.numpy(), h2.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_CASES[:2])
def test_chunked_reference_bf16_matches_jax(b, s, h, p, n, chunk):
    """bf16 x, b, c: y rounded to bf16 once, at the end, as the kernel's bf16 entry does."""
    (xj, xt), (aj, at), (bj, bt), (cj, ct) = _ssd_inputs(np.random.default_rng(13), b, s, h, p, n,
                                                         "bfloat16")
    y, hf = kssd.chunked_reference(xt, at, bt, ct, chunk)
    yj, hj = jref.ssd(xj, aj, bj, cj, chunk)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(to_numpy(y), np.asarray(yj, np.float32), rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(hf.numpy(), np.asarray(hj), rtol=3e-2, atol=3e-2)


def test_chunked_reference_fills_the_kernels_workspaces():
    """states[:, c] holds the state entering chunk c (the O(S) recurrence's state after
    c*l steps), decay the chunk's sum of a, and cb is C·Bᵀ transposed with j > i zero."""
    b, s, h, p, n, l = 2, 64, 3, 8, 4, 16
    (_, xt), (_, at), (_, bt), (_, ct) = _ssd_inputs(np.random.default_rng(14), b, s, h, p, n)
    ws = kssd.workspaces(b, s, h, p, n, l, torch.device("cpu"))
    kssd.chunked_reference(xt, at, bt, ct, l, ws)
    states, cb, decay = ws
    for c in range(s // l):
        want = (torch.zeros((b, h, p, n)) if c == 0
                else kssd.sequential(xt[:, :c * l], at[:, :c * l], bt[:, :c * l], ct[:, :c * l])[1])
        np.testing.assert_allclose(states[:, c].numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(decay.numpy(), at.reshape(b, s // l, l, h).sum(2).numpy(), rtol=1e-5,
                               atol=1e-6)
    i, j = torch.arange(l)[None, :], torch.arange(l)[:, None]
    cbt = torch.einsum("bcin,bcjn->bcji", ct.reshape(b, s // l, l, n), bt.reshape(b, s // l, l, n))
    np.testing.assert_allclose(cb.numpy(), torch.where(j <= i, cbt, 0.0).numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("arch,b,s,h,p,n,mb", [("mamba2", 1, 1024, 24, 64, 128, 6.3),
                                               ("hymba", 1, 2048, 50, 64, 16, 3.3)])
def test_ssd_workspaces_at_the_served_shapes(arch, b, s, h, p, n, mb):
    """The chunk states' float32 workspace: 6.3 MB for mamba2, 3.3 MB for hymba (chunk
    128); every pass has at least one block per SM."""
    l = 128
    states, cb, decay = kssd.workspaces(b, s, h, p, n, l, torch.device("meta"))
    assert tuple(states.shape) == (b, s // l, h, p, n) and tuple(cb.shape) == (b, s // l, l, l)
    assert tuple(decay.shape) == (b, s // l, h)
    assert round(states.numel() * 4 / 1e6, 1) == mb
    assert (s // l) * h * b >= SMS  # the chunk and output passes' (chunk, head, batch) grid


# ------------------------------------------------------------ the build cache sees headers
def test_library_cache_key_covers_the_shared_headers(tmp_path, monkeypatch):
    """Editing a header that a source includes builds every library anew: the target
    name changes with a .cuh's bytes, and not with a file the build never reads."""
    for src in _build.CSRC.iterdir():
        if src.suffix in (".cu", ".cuh"):
            (tmp_path / src.name).write_bytes(src.read_bytes())
    assert (tmp_path / "hopper.cuh").exists()
    assert '#include "hopper.cuh"' in (tmp_path / "moe_gmm.cu").read_text()
    assert '#include "hopper.cuh"' in (tmp_path / "flash_attention.cu").read_text()
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {name: _build._target(name) for name in _build.SIGNATURES}
    (tmp_path / "notes.txt").write_text("not a source")
    assert {name: _build._target(name) for name in _build.SIGNATURES} == before
    with open(tmp_path / "hopper.cuh", "a") as fh:
        fh.write("// edited\n")
    after = {name: _build._target(name) for name in _build.SIGNATURES}
    assert all(after[name] != before[name] for name in _build.SIGNATURES)
    assert all(after[name].name.startswith(f"{name}-") for name in after)
    with open(tmp_path / "ssd.cu", "a") as fh:
        fh.write("// edited\n")
    assert _build._target("ssd") != after["ssd"] and _build._target("rmsnorm") == after["rmsnorm"]
