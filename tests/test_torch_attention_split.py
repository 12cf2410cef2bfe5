"""Host-side logic of the two attention kernels, on the CPU.

The decode kernel splits the KV axis: ``split_plan`` cuts the cache into
splits and ``split_reference`` is the kernel's per-split softmax and combine
in plain float32 PyTorch; both are held here against the JAX package's
Pallas decode kernel (interpret mode) and against the plain version. The
flash wrapper picks one of its two kernels by (dtype, head_dim). And every C
entry's parameter list in ``csrc/*.cu`` matches the ctypes signature that
``_build.SIGNATURES`` gives it.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.models.attention import decode_attention as jax_decode  # noqa: E402
from repro_torch.bridge import to_numpy, to_tensor  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attention as kdec  # noqa: E402
from repro_torch.kernels import flash_attention as kfl  # noqa: E402

DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _tol(dtype):  # tests/test_kernels.py::_tol
    return dict(rtol=3e-2, atol=3e-2) if dtype == "bfloat16" else dict(rtol=2e-3, atol=2e-3)


def _pair(rng, shape, dtype):
    j = jnp.asarray(rng.standard_normal(shape).astype(np.float32), DTYPES[dtype])
    return j, to_tensor(np.asarray(j), "cpu")


def _slots(kind, b, s):
    """(slot_pos [B, S], cur_pos [B]) of a cache of kind ``kind``."""
    ar = np.arange(s)[None]
    if kind == "ring":      # positions cur-S+1 .. cur at slot pos % S, rows 0-1 wrapped
        cur = np.array([2 * s + 5, s + 3, s // 2][:b] + [7] * max(0, b - 3), np.int32)
        slot = np.full((b, s), -1, np.int32)
        for r, c in enumerate(cur):
            pos = np.arange(max(0, c - s + 1), c + 1)
            slot[r, pos % s] = pos
        return slot, cur
    fill = np.array([s, s - 37, 20][:b] + [9] * max(0, b - 3))
    slot = np.where(ar < fill[:, None], ar, -1).astype(np.int32)
    cur = (fill - 1).astype(np.int32)
    if kind == "holed":
        slot[:, 3:9] = -1
        slot[0, -5:] = -1
    if kind == "empty_row":  # row 1 has no valid slot: the mean of V over all S
        slot[1] = -1
    return slot, cur


# kind, s, hq, hkv, dh, window, Pallas kv_block (a divisor of s)
CASES = [
    ("linear", 100, 8, 2, 32, 0, 20),     # s not divisible by the split
    ("linear", 128, 4, 4, 16, 0, 32),     # G = 1
    ("ring", 96, 10, 2, 16, 40, 32),      # wrapped ring under a window, G = 5
    ("linear", 160, 8, 2, 32, 24, 32),    # a window over a linear cache
    ("holed", 112, 6, 2, 16, 0, 16),      # holes inside the filled range
    ("empty_row", 96, 8, 2, 16, 0, 32),   # a row without a valid slot
    ("linear", 400, 18, 1, 16, 0, 50),    # G = 18: rows in chunks, later splits all invalid
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,s,hq,hkv,dh,window,kv_block", CASES)
def test_split_reference_matches_pallas_and_plain(kind, s, hq, hkv, dh, window, kv_block, dtype):
    b = 3
    rng = np.random.default_rng(7)
    qj, qt = _pair(rng, (b, hq, dh), dtype)
    kj, kt = _pair(rng, (b, s, hkv, dh), dtype)
    vj, vt = _pair(rng, (b, s, hkv, dh), dtype)
    slot, cur = _slots(kind, b, s)
    nsplit, per = kdec.split_plan(b, hkv, s, hq // hkv, 4 if dtype == "float32" else 2, dh)
    assert nsplit > 1  # the combine merges several splits here
    got = kdec.split_reference(qt, kt, vt, torch.from_numpy(slot), torch.from_numpy(cur),
                               window=window)
    want = jops.decode_attention(qj, kj, vj, jnp.asarray(slot), jnp.asarray(cur), window=window,
                                 kv_block=kv_block, interpret=True, use_pallas=True)
    plain = kdec.plain(qt, kt, vt, torch.from_numpy(slot), torch.from_numpy(cur), window=window)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    np.testing.assert_allclose(to_numpy(got), np.asarray(want, np.float32), **_tol(dtype))
    np.testing.assert_allclose(to_numpy(got), to_numpy(plain), **_tol(dtype))


@pytest.mark.parametrize("kind,window", [("linear", 0), ("ring", 40), ("empty_row", 0)])
def test_split_reference_f32_query_on_bf16_cache_matches_jax(kind, window):
    """A float32 q on the bf16 cache: probabilities rounded to bf16 before PV, relative
    to the split's max; the JAX model's decode attention rounds the normalised ones."""
    b, s, hq, hkv, dh = 3, 96, 8, 2, 32
    rng = np.random.default_rng(8)
    qj, qt = _pair(rng, (b, hq, dh), "float32")
    kj, kt = _pair(rng, (b, s, hkv, dh), "bfloat16")
    vj, vt = _pair(rng, (b, s, hkv, dh), "bfloat16")
    slot, cur = _slots(kind, b, s)
    got = kdec.split_reference(qt, kt, vt, torch.from_numpy(slot), torch.from_numpy(cur),
                               window=window)
    want = jax_decode(qj, kj, vj, jnp.asarray(slot), jnp.asarray(cur), window=window)
    plain = kdec.plain(qt, kt, vt, torch.from_numpy(slot), torch.from_numpy(cur), window=window)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(to_numpy(got), np.asarray(want, np.float32), **_tol("bfloat16"))
    np.testing.assert_allclose(to_numpy(got), to_numpy(plain), **_tol("bfloat16"))


# (B, Hkv, S, G): the serving paths' decode shapes (granite, olmoe, hymba's ring and
# global cache, batch 1) and small, ragged and long caches
PLANS = [(4, 8, 1024, 4), (4, 16, 1024, 1), (4, 5, 1024, 5), (4, 5, 2048, 5), (1, 8, 1024, 4),
         (2, 2, 100, 4), (1, 1, 8, 1), (3, 2, 400, 18), (64, 8, 8192, 4), (1, 8, 131072, 4),
         (128, 32, 4096, 4), (2, 4, 17, 2)]


@pytest.mark.parametrize("elem_size,dh", [(2, 128), (2, 64), (4, 128)])
@pytest.mark.parametrize("b,hkv,s,g", PLANS)
def test_split_plan_covers_every_slot_once_and_fills_the_card(b, hkv, s, g, elem_size, dh):
    nsplit, per = kdec.split_plan(b, hkv, s, g, elem_size, dh)
    assert per % kdec.SPLIT_ALIGN == 0
    assert 0 < per <= kdec.round_slots(g, elem_size, dh) <= kdec.MAX_SPLIT_SLOTS
    owner = np.zeros(s, int)
    for i in range(nsplit):
        owner[i * per:min(s, (i + 1) * per)] += 1
        assert i * per < s  # no split past the cache
    assert (owner == 1).all()
    blocks = b * hkv * -(-g // kdec.ROWS_PER_BLOCK) * nsplit
    most_splits = -(-s // kdec.SPLIT_ALIGN)  # S allows no more splits than this
    assert blocks >= kdec.BLOCKS_PER_SM * kdec.SMS or nsplit == most_splits


@pytest.mark.parametrize("g,elem_size,dh,slots", [
    (4, 2, 128, 64),   # granite bf16: 8 lane groups of 16 lanes, 8 slots each
    (1, 2, 128, 64),   # olmoe
    (5, 2, 64, 64),    # hymba: 8 rows of 8 values take 128 registers, 4 slots each
    (4, 4, 128, 32),   # float32: 32 lanes a slot
    (4, 4, 64, 64),
    (2, 2, 16, 512),   # 2 lanes a slot: capped at MAX_SPLIT_SLOTS
])
def test_round_slots_is_one_round_of_the_kernels_loads(g, elem_size, dh, slots):
    """Slots a block holds in flight: warps x lane groups x loads_in_flight, which the
    source states as the limit its launch checks."""
    assert kdec.round_slots(g, elem_size, dh) == slots
    src = (_build.CSRC / "decode_attention.cu").read_text()
    assert "return rows * vec >= 64 ? 4 : 8;" in src
    assert "loads_in_flight(rmax, kVec) * kWarps * (32 / lps)" in src


@pytest.mark.parametrize("dtype,dh,entry", [
    (torch.bfloat16, 128, "flash_attention_bf16_wgmma"),
    (torch.bfloat16, 64, "flash_attention_bf16_wgmma"),
    (torch.bfloat16, 32, "flash_attention_bf16"),
    (torch.bfloat16, 96, "flash_attention_bf16"),
    (torch.float32, 128, "flash_attention_f32"),
    (torch.float32, 64, "flash_attention_f32"),
])
def test_flash_kernel_for_picks_the_kernel_the_source_names(dtype, dh, entry):
    """bf16 at head_dim 64 and 128 go to the tensor-core kernel, which dispatches
    exactly those head dims to flash_kernel_wgmma and issues wgmma; everything else
    to the CUDA-core kernel."""
    assert kfl.kernel_for(dtype, dh) == entry
    assert entry in _build.SIGNATURES["flash_attention"]
    src = (_build.CSRC / "flash_attention.cu").read_text()
    body = src[src.index(f'extern "C" int {entry}('):]
    body = body[:body.index("\n}\n")]
    if entry.endswith("_wgmma"):
        dims = tuple(int(d) for d in re.findall(r"if \(dh == (\d+)\) return wg::launch<\1>", body))
        assert dims == kfl.WGMMA_HEAD_DIMS
        assert "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16" in src
    else:
        assert "simt::launch<" in body


_CTYPE = {"const void*": _build._P, "void*": _build._P, "int": _build._I, "float": _build._F}


@pytest.mark.parametrize("lib", sorted(_build.SIGNATURES))
def test_c_entries_match_their_ctypes_signatures(lib):
    """A ctypes signature that disagrees with the C prototype passes garbage (a
    pointer cut to 32 bits, arguments shifted): each entry's parameters, in order."""
    src = (_build.CSRC / f"{lib}.cu").read_text()
    protos = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src))
    assert sorted(protos) == sorted(_build.SIGNATURES[lib])
    for name, params in protos.items():
        types = [_CTYPE[" ".join(p.split()[:-1])] for p in params.split(",")]
        assert tuple(types) == tuple(_build.SIGNATURES[lib][name]), name
