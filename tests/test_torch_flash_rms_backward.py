"""The backward kernels of ``flash_attention`` and ``rmsnorm``, host side, on the CPU.

``flash_attention.chunked_backward_reference`` and ``rmsnorm.chunked_backward_reference``
(each backward kernel's passes in float32 PyTorch, with P and dS rounded where the
kernels round them) against ``jax.vjp`` of the reference's ``chunked_attention`` and
``rms_norm``: causal, windowed with G = 5, non-causal with Sq != Sk, and rows that
allow no key; the row logsumexp they read (``plain_lse``, what the forward kernels
write) against numpy's. ``backward_cost`` against ``allowed_pairs`` and its formula.
Each Function's backward on the CPU is ``plain_backward`` inside its own kernel scope,
and on ``meta`` tensors returns empty outputs of the gradients' shapes; the wrappers
refuse CPU tensors; the C entries have their ctypes signatures. ``chip_smoke.py``'s
check of each kernel gradient against its chunked reference takes a rounding flip and
refuses a dropped or mis-scaled tile; a row that allows no key passes the reference's
gradient (ROADMAP C3, repaired), and the TPU kernel averages such a row over the blocks it
visits, where the reference and the port take the mean over every key (C4). The rmsnorm
backward's partition (``backward_plan``) takes every row once and fills every thread at the
training widths. The one-pass kernel's work list (``backward_plan``,
``backward_schedule``) is simulated: every pair once, a fixed order, no deadlock. The
launches run only on the card (``chip_smoke.py`` phases 2 and 6). Inputs come from numpy
seeds.
"""
import importlib.util
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jax_layers  # noqa: E402
from repro.models.attention import chunked_attention as jax_chunked_attention  # noqa: E402
from repro_torch.bridge import to_numpy, to_tensor  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as kfl  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rmsnorm as krms  # noqa: E402
from repro_torch.launch.hlo_counter import CostCounter  # noqa: E402

DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _tol(dtype):   # tests/test_kernels.py::_tol
    return dict(rtol=3e-2, atol=3e-2) if dtype == "bfloat16" else dict(rtol=2e-3, atol=2e-3)


def _pair(rng, shape, dtype="float32"):
    """One numpy-seeded array as a JAX array and a CPU tensor with the same bits."""
    j = jnp.asarray(rng.standard_normal(shape).astype(np.float32), DTYPES[dtype])
    return j, to_tensor(np.asarray(j), "cpu")


@pytest.fixture(autouse=True)
def _counters_stay_zero():
    """The CPU path launches nothing, forward or backward."""
    ops.reset_launch_counts()
    yield
    assert set(ops.launch_counts().values()) == {0}


# ------------------------------------------------------------ flash attention
FLASH_CASES = [  # (B, Sq, Sk, Hq, Hkv, dh, causal, window)
    (2, 200, 200, 8, 2, 32, True, 0),     # causal, G = 4, several key and query blocks
    (1, 300, 300, 10, 2, 16, True, 70),   # windowed, G = 5 (hymba's group)
    (2, 100, 170, 4, 4, 32, False, 0),    # non-causal, Sq != Sk (whisper's cross)
    (1, 150, 40, 4, 2, 16, True, 20),     # rows 59 .. 149 allow no key
    (1, 130, 60, 2, 1, 8, False, 30),     # non-causal window, Sq > Sk: rows 89 .. allow none
]
_IDS = ["sq{}-sk{}-h{}x{}-{}-w{}".format(c[1], c[2], c[3], c[4], "causal" if c[6] else "full",
                                         c[7]) for c in FLASH_CASES]


def _flash_inputs(case, dtype, seed=2):
    b, sq, sk, hq, hkv, dh, _, _ = case
    rng = np.random.default_rng(seed)
    return [_pair(rng, shape, dtype) for shape in ((b, sq, hq, dh), (b, sk, hkv, dh),
                                                   (b, sk, hkv, dh), (b, sq, hq, dh))]


def _no_key_rows(sq, sk, causal, window):
    """Query positions whose mask allows no key."""
    return [i for i in range(sq) if kfl.allowed_pairs(i + 1, sk, causal, window)
            == kfl.allowed_pairs(i, sk, causal, window)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=_IDS)
def test_flash_chunked_backward_reference_matches_reference_vjp(case, dtype):
    """The bf16 kernel's pass (D, then each 128-key block over the query tiles its mask
    reaches, the G heads in turn, each query tile summing its dQ partials from the highest
    key block down) from the forward's logsumexp gives ``jax.vjp``'s gradients for the whole
    output gradient. A row that allows no key is the mean of V over every key, as in the
    reference (whose KV block, min(512, Sk), pads no column here): it passes dO/Sk to every
    key's dV and nothing to dQ and dK."""
    b, sq, sk, hq, _, dh, causal, window = case
    (qj, qt), (kj, kt), (vj, vt), (doj, dot) = _flash_inputs(case, dtype)
    dead = _no_key_rows(sq, sk, causal, window)
    f = lambda q, k, v: jax_chunked_attention(q, k, v, causal=causal, window=window,
                                              q_block=32)
    out, want = jax.jit(lambda q, k, v, do: (f(q, k, v), jax.vjp(f, q, k, v)[1](do)))(
        qj, kj, vj, doj)
    o = to_tensor(np.asarray(out), "cpu")
    lse = kfl.plain_lse(qt, kt, causal=causal, window=window)
    got = kfl.chunked_backward_reference(qt, kt, vt, o, lse, dot, causal=causal,
                                         window=window)
    for name, g, w, t in zip("qkv", got, want, (qt, kt, vt)):
        assert g.dtype == t.dtype and g.shape == t.shape and g.is_contiguous(), name
        np.testing.assert_allclose(to_numpy(g), np.asarray(w, np.float32), err_msg=f"d{name}",
                                   **_tol(dtype))
    assert bool(torch.isinf(lse[..., dead]).all()) and bool(torch.isfinite(
        lse[..., [i for i in range(sq) if i not in dead]]).all())
    assert dead == list(range(kfl.first_dead_row(sq, sk, window), sq))
    if dead:
        assert not bool(got[0][:, dead].any())


@pytest.mark.parametrize("case", FLASH_CASES, ids=_IDS)
def test_plain_lse_is_each_rows_logsumexp(case):
    """``plain_lse``: each row's logsumexp of its allowed scaled scores, [B, Hq, Sq],
    -inf where the row allows no key (numpy in float64)."""
    b, sq, sk, hq, hkv, dh, causal, window = case
    (_, qt), (_, kt), _, _ = _flash_inputs(case, "float32", seed=5)
    got = kfl.plain_lse(qt, kt, causal=causal, window=window, rows=64)
    q, k = qt.numpy().astype(np.float64), kt.numpy().astype(np.float64)
    k = np.repeat(k, hq // hkv, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q, k) * dh**-0.5
    ok = kfl._allowed(sq, sk, causal, window, "cpu").numpy()
    s = np.where(ok, s, -np.inf)
    m = s.max(-1, keepdims=True)
    with np.errstate(invalid="ignore", divide="ignore"):
        want = (np.log(np.exp(s - np.where(np.isinf(m), 0, m)).sum(-1, keepdims=True))
                + m)[..., 0]
    assert got.shape == (b, hq, sq) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", FLASH_CASES, ids=_IDS)
def test_flash_chunked_backward_reference_equals_the_formula(case):
    """In float32 the kernels' passes and ``plain_backward`` are the same sums."""
    _, _, _, _, _, _, causal, window = case
    (_, q), (_, k), (_, v), (_, do) = _flash_inputs(case, "float32", seed=9)
    o = kfl.plain(q, k, v, causal=causal, window=window)
    lse = kfl.plain_lse(q, k, causal=causal, window=window)
    got = kfl.chunked_backward_reference(q, k, v, o, lse, do, causal=causal, window=window)
    want = kfl.plain_backward(q, k, v, o, do, causal=causal, window=window)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-5, err_msg=name)


# ... and one whose Sk (520) the reference's and plain's KV block (512) does not divide
NO_KEY_CASES = [FLASH_CASES[3], FLASH_CASES[4], (1, 560, 520, 2, 1, 8, True, 16)]


@pytest.mark.parametrize("case", NO_KEY_CASES, ids=[_IDS[3], _IDS[4], "sq560-sk520-w16"])
def test_a_row_that_allows_no_key_averages_v_but_passes_no_gradient_back(case):
    """ROADMAP C3, repaired: on a row that allows no key ``plain`` gives, as the reference
    does, the mean of V over every key and the zero columns that pad Sk to the KV block
    (``dead_row_keys``: Sk when the block divides it, 1024 for Sk = 520 and the default 512),
    and the backward is that mean's gradient: the row's output gradient reaches every key's
    dV as dO/``dead_row_keys`` (summed over the G heads) and passes nothing back to Q and K.
    ``plain_backward`` and ``chunked_backward_reference`` (the kernel's pass) give
    ``jax.vjp``'s gradients, the reference at its default KV block, for an output gradient on
    those rows alone. Such a row needs a window and Sq > Sk + window - 1."""
    _, sq, sk, hq, hkv, _, causal, window = case
    (qj, q), (kj, k), (vj, v), (_, do) = _flash_inputs(case, "float32", seed=6)
    dead = _no_key_rows(sq, sk, causal, window)
    assert dead
    keys = kfl.dead_row_keys(sk)
    assert keys == (sk if sk <= 512 else 1024)
    o = kfl.plain(q, k, v, causal=causal, window=window)
    mean_v = (v.sum(dim=1, keepdim=True) / keys).repeat_interleave(hq // hkv, dim=2)
    torch.testing.assert_close(o[:, dead], mean_v.expand(-1, len(dead), -1, -1))
    only_dead = torch.zeros_like(do)
    only_dead[:, dead] = do[:, dead]
    f = lambda q, k, v: jax_chunked_attention(q, k, v, causal=causal, window=window,
                                              q_block=32)
    want = jax.vjp(f, qj, kj, vj)[1](jnp.asarray(to_numpy(only_dead)))
    dv = only_dead.reshape(*do.shape[:2], hkv, -1, do.shape[-1]).sum(dim=(1, 3)) / keys
    lse = kfl.plain_lse(q, k, causal=causal, window=window)
    for grads in (kfl.plain_backward(q, k, v, o, only_dead, causal=causal, window=window),
                  kfl.chunked_backward_reference(q, k, v, o, lse, only_dead, causal=causal,
                                                 window=window)):
        assert not bool(grads[0].any()) and not bool(grads[1].any())
        torch.testing.assert_close(grads[2], dv[:, None].expand_as(v), rtol=1e-6, atol=1e-6)
        for name, g, w in zip("qkv", grads, want):
            np.testing.assert_allclose(to_numpy(g), np.asarray(w, np.float32), rtol=2e-5,
                                       atol=2e-6, err_msg=f"d{name}")


@pytest.mark.parametrize("case", NO_KEY_CASES, ids=[_IDS[3], _IDS[4], "sq560-sk520-w16"])
def test_the_pallas_kernel_averages_a_row_without_a_key_over_the_blocks_it_visits(case):
    """A fault of the reference that the port does not copy (ROADMAP C, C4): on a row that
    allows no key the TPU kernel (``repro.kernels.flash_attention``, in interpret mode at its
    default 128-position blocks) averages V over the KV blocks it visits, zero padding
    included (it skips a masked block with ``pl.when`` and scores a visited one's masked
    columns alike), and gives 0 where it visits none; the reference model's
    ``chunked_attention``, and the port's ``plain`` with it (and the port's forward kernels on
    the card, ``chip_smoke.py`` phase 2), take the mean over ``dead_row_keys(Sk)`` columns.
    The two agree on every other row."""
    from repro.kernels.flash_attention import flash_attention as pallas_flash

    b, sq, sk, hq, hkv, dh, causal, window = case
    (qj, q), (kj, k), (vj, v), _ = _flash_inputs(case, "float32", seed=6)
    got = np.asarray(pallas_flash(qj, kj, vj, causal=causal, window=window, interpret=True))
    ref = np.asarray(jax_chunked_attention(qj, kj, vj, causal=causal, window=window))
    np.testing.assert_allclose(to_numpy(kfl.plain(q, k, v, causal=causal, window=window)), ref,
                               rtol=1e-5, atol=1e-5)
    first = kfl.first_dead_row(sq, sk, window)
    np.testing.assert_allclose(got[:, :first], ref[:, :first], **_tol("float32"))
    qb, kb = min(128, sq), min(128, sk)   # the Pallas kernel's blocks at its defaults
    vpad = np.concatenate([to_numpy(v), np.zeros((b, (-sk) % kb, hkv, dh), np.float32)], axis=1)
    for i in range(first, sq):
        q0 = i // qb * qb
        seen = [j for j in range(0, sk, kb) if (not causal or j <= q0 + qb - 1)
                and q0 - (j + kb - 1) < window]
        want = (sum(vpad[:, j:j + kb].sum(axis=1) for j in seen) / (kb * len(seen)) if seen
                else np.zeros((b, hkv, dh), np.float32))
        np.testing.assert_allclose(got[:, i], np.repeat(want, hq // hkv, axis=1), rtol=1e-5,
                                   atol=1e-6, err_msg=f"row {i}")
    assert np.abs(got[:, first:] - ref[:, first:]).max() > 0.05


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chip_smokes_near_check_takes_rounding_and_refuses_a_dropped_or_misscaled_tile(dtype):
    """``chip_smoke._check_near``, which holds each gradient of the card's backward kernels
    against ``chunked_backward_reference``: a logsumexp one float32 ulp off (P rounding to
    bf16 on the other side, as the kernel's ``exp2`` may) passes; one 64-key tile left out
    of every row (a middle one, or the last), or the last query block's dq at half its
    size, fails, at a small causal G = 4 shape."""
    smoke = _chip_smoke()
    case = (1, 512, 512, 8, 2, 64, True, 0)
    (_, q), (_, k), (_, v), (_, do) = _flash_inputs(case, dtype, seed=4)
    o = kfl.plain(q, k, v)
    lse = kfl.plain_lse(q, k)
    want = kfl.chunked_backward_reference(q, k, v, o, lse, do)
    nudged = kfl.chunked_backward_reference(q, k, v, o, torch.nextafter(lse, lse + 1), do)
    for name, g, w in zip(("dq", "dk", "dv"), nudged, want):
        smoke._check_near(f"d{name}", g, w, dtype)
    allowed = kfl._allowed
    wrong = []
    try:
        for tile in (3, 7):   # a middle one, and the last, which only the last rows reach
            kfl._allowed = lambda *a, tile=tile: allowed(*a) & (torch.arange(512)[None] // 64 != tile)
            wrong += zip(("dq", "dk", "dv"), kfl.chunked_backward_reference(q, k, v, o, lse, do),
                         want)
    finally:
        kfl._allowed = allowed
    halved = want[0].clone()
    halved[:, -128:] *= 0.5
    for name, g, w in (*wrong, ("dq", halved, want[0])):
        with pytest.raises(AssertionError):
            smoke._check_near(name, g, w, dtype)


@pytest.mark.parametrize("case", FLASH_CASES, ids=_IDS)
def test_flash_backward_cost_counts_the_allowed_pairs(case):
    """8·dh operations a query head and allowed pair; q, k, v, o, dO, lse read and dq,
    dk, dv written once."""
    b, sq, sk, hq, hkv, dh, causal, window = case
    for dt in (torch.float32, torch.bfloat16):
        q, k = torch.empty((b, sq, hq, dh), dtype=dt), torch.empty((b, sk, hkv, dh), dtype=dt)
        c = kfl.backward_cost(q.to("meta"), k.to("meta"), k.to("meta"), causal=causal,
                              window=window)
        pairs = int(kfl._allowed(sq, sk, causal, window, "cpu").sum())
        assert pairs == kfl.allowed_pairs(sq, sk, causal, window)
        assert c.flops == 8.0 * b * hq * dh * pairs
        size = q.element_size()
        assert c.bytes == 4 * q.numel() * size + 4 * k.numel() * size + 4 * b * hq * sq


# ------------------------------------------- the one-pass kernel's work list
# (B, Sq, Sk, Hq, Hkv, causal, window): the bf16 training shapes (chip_smoke.py's
# TRAIN_FLASH_BACKWARD_CASES: granite-8b, hymba-1.5b's sliding layers, whisper-base's cross
# attention) and the five FLASH_CASES
SCHEDULE_CASES = {"granite": (2, 4096, 4096, 32, 8, True, 0),
                  "hymba sliding": (2, 4096, 4096, 25, 5, True, 1024),
                  "whisper cross": (1, 448, 1500, 8, 8, False, 0),
                  **{i: (c[0], c[1], c[2], c[3], c[4], c[6], c[7]) for i, c in zip(_IDS, FLASH_CASES)}}
H100_BLOCKS = 132   # one block an SM (flash_bwd_wgmma's shared memory holds one)


def _read_schedule(sched):
    """``backward_schedule``'s array as (reach, rows, turn of (item, tile))."""
    blocks, width, nkb, nqt = (int(x) for x in sched[:4])
    o = 4
    reach = list(zip(sched[o:o + nkb], sched[o + nkb:o + 2 * nkb]))
    o += 2 * nkb
    table = sched[o:o + blocks * (width + 1)].reshape(blocks, width + 1)
    rows = [[int(x) for x in r[1:1 + r[0]]] for r in table]
    o += blocks * (width + 1)
    n_items = sum(len(r) for r in rows)
    offsets, turns = sched[o:o + n_items], sched[o + n_items:]
    turn = {(item, t): int(turns[offsets[item] + t - reach[item % nkb][0]])
            for item in range(n_items) for t in range(*reach[item % nkb])}
    return reach, rows, turn


def _simulate(b, hq, hkv, sched):
    """The kernel's grid in unit steps: each block walks its row, an item a step for its
    K/V load and then a step for each (query tile, head) of its reach; a step that adds a
    dQ partial waits until the tile's flag counts its turn, and counts one more when it
    ends. Returns (time, steps, waiting steps, each (batch, head, tile)'s writers in order);
    raises if every unfinished block waits (a deadlock)."""
    reach, rows, turn = _read_schedule(sched)
    nkb, g = len(reach), hq // hkv
    progs = []
    for row in rows:
        steps = []
        for item in row:
            grp, m = divmod(item, nkb)
            bi, kvh = divmod(grp, hkv)
            steps.append(None)
            steps += [((bi, kvh * g + gi, t), turn[item, t], m)
                      for t in range(*reach[m]) for gi in range(g)]
        progs.append(steps)
    flag, order, pos = {}, {}, [0] * len(progs)
    time = waits = 0
    while any(p < len(steps) for p, steps in zip(pos, progs)):
        time += 1
        done, moved = [], False
        for j, steps in enumerate(progs):
            if pos[j] == len(steps):
                continue
            step = steps[pos[j]]
            if step is not None and flag.get(step[0], 0) != step[1]:
                waits += 1
                continue
            pos[j] += 1
            moved = True
            if step is not None:
                done.append(step)
        if not moved:
            raise AssertionError(f"deadlock at time {time}")
        for tile, _, m in done:
            flag[tile] = flag.get(tile, 0) + 1
            order.setdefault(tile, []).append(m)
    return time, sum(len(st) for st in progs), waits, order


@pytest.mark.parametrize("case", list(SCHEDULE_CASES), ids=str)
def test_backward_plan_is_the_allowed_pairs(case):
    """``backward_plan``: key block m reaches query tile t exactly when the mask allows a
    pair of them (``_allowed``, block by block); each block's tiles and each tile's key
    blocks are runs, and a tile that no block reaches holds only rows that allow no key."""
    _, sq, sk, _, _, causal, window = SCHEDULE_CASES[case]
    plan = kfl.backward_plan(sq, sk, causal, window)
    ok = kfl._allowed(sq, sk, causal, window, "cpu").numpy()
    kb, qt = kfl.KEY_BLOCK, kfl.QUERY_TILE
    for m, (lo, hi) in enumerate(plan.reach):
        for t, (wlo, whi) in enumerate(plan.writers):
            meets = bool(ok[t * qt:(t + 1) * qt, m * kb:(m + 1) * kb].any())
            assert meets == (lo <= t < hi) == (wlo <= m <= whi), (m, t)
    for t, (wlo, whi) in enumerate(plan.writers):
        if wlo > whi:
            assert t * qt >= kfl.first_dead_row(sq, sk, window)


@pytest.mark.parametrize("case", list(SCHEDULE_CASES), ids=str)
def test_backward_schedule_takes_every_pair_once_in_a_fixed_order_and_cannot_deadlock(case):
    """``backward_schedule`` on the H100's grid (132 co-resident blocks, or one an item):
    every (key block, query tile, head) pair that holds an allowed pair is one step of one
    item, and every item is in one block's row; each (batch, head, query tile) takes its dQ
    partials from its highest key block down, turn 0 first, and its last writer is the one
    whose turn is the count less one; the simulated grid ends (on 132 blocks and on 3). No
    item waits on a causal or windowed shape. On a non-causal one every key block reaches
    every tile, so key block m waits for the ones above it: at most n_key_blocks - 1 - m
    steps, the least a fixed order allows (the first writer's last tile has all the others
    still to come)."""
    b, sq, sk, hq, hkv, causal, window = SCHEDULE_CASES[case]
    plan = kfl.backward_plan(sq, sk, causal, window)
    nkb, g = len(plan.reach), hq // hkv
    items = kfl.backward_items(b, hkv, plan)
    assert sorted(items) == list(range(b * hkv * nkb))
    ok = kfl._allowed(sq, sk, causal, window, "cpu").numpy()
    kb, qt = kfl.KEY_BLOCK, kfl.QUERY_TILE
    want = {(bi, kvh * g + gi, m, t) for bi in range(b) for kvh in range(hkv) for gi in range(g)
            for m in range(nkb) for t in range(len(plan.writers))
            if ok[t * qt:(t + 1) * qt, m * kb:(m + 1) * kb].any()}
    for blocks in (min(len(items), H100_BLOCKS), 3):
        sched = kfl.backward_schedule(b, sq, sk, hq, hkv, causal, window, blocks)
        assert sched.dtype == np.int32
        reach, rows, turn = _read_schedule(sched)
        assert reach == plan.reach
        writers = plan.writers
        assert sorted(i for r in rows for i in r) == list(range(len(items)))
        for r in rows:   # a block takes its items in the list's order
            assert [items.index(i) for i in r] == sorted(items.index(i) for i in r)
        steps = [((i // nkb) // hkv, (i // nkb) % hkv * g + gi, i % nkb, t)
                 for r in rows for i in r for t in range(*reach[i % nkb]) for gi in range(g)]
        assert len(steps) == len(set(steps)) and set(steps) == want
        for (item, t), k in turn.items():
            lo, hi = writers[t]
            assert k == hi - item % nkb   # from the highest key block down
        time, work, waits, order = _simulate(b, hq, hkv, sched)
        assert set(order) == {(bi, h, t) for bi, h, _, t in want}
        for (_, _, t), ms in order.items():
            assert ms == list(range(writers[t][1], writers[t][0] - 1, -1))
        if blocks == H100_BLOCKS or blocks == len(items):
            if causal or window > 0:
                assert waits == 0, (time, work, waits)
            else:
                assert waits <= b * hkv * nkb * (nkb - 1) // 2, (time, work, waits)
            assert time <= work / blocks + max(
                (hi - lo) * g + 1 for lo, hi in reach) + (0 if causal or window > 0 else nkb)


# -------------------------------------------------------------------- rmsnorm
# the training widths at a few rows (mamba2's 768, hymba's 1600 and 3200), and rows past
# BACKWARD_BLOCKS (600 and 270: two and three rows a block)
RMS_SHAPES = [(4, 128), (2, 37, 64), (3, 5, 7, 32), (600, 24), (3, 768), (2, 5, 1600), (4, 3200),
              (270, 64)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", RMS_SHAPES)
def test_rmsnorm_chunked_backward_reference_matches_reference_vjp(shape, dtype):
    """The kernel's two passes under ``backward_plan`` (dx, each team's column sums over its
    rows and the block's teams in order, then the blocks' sums in a fixed tree) give
    ``jax.vjp``'s gradients; dscale relative to its largest entry."""
    rng = np.random.default_rng(1)
    (xj, xt), (sj, st), (gj, gt) = (_pair(rng, s, dtype) for s in (shape, shape[-1:], shape))
    _, vjp = jax.vjp(lambda x, s: jax_layers.rms_norm(x, s, 1e-5), xj, sj)
    dx_want, ds_want = vjp(gj)
    dx, ds = krms.chunked_backward_reference(xt, st, gt, 1e-5)
    assert dx.dtype == xt.dtype and ds.dtype == st.dtype and dx.shape == xt.shape
    np.testing.assert_allclose(to_numpy(dx), np.asarray(dx_want, np.float32), **_tol(dtype))
    ds_want = np.asarray(ds_want, np.float32)
    top = np.abs(ds_want).max()
    np.testing.assert_allclose(to_numpy(ds) / top, ds_want / top, **_tol(dtype))


@pytest.mark.parametrize("rows", [1, 5, 264, 265, 528, 529, 2000, 8192])
def test_rmsnorm_backward_blocks_take_every_row_once(rows):
    """The rows pass's blocks: at most ``BACKWARD_BLOCKS`` (half as many where a thread holds
    more than ``HELD`` elements), none empty, each a run of ``rows_per_block`` contiguous rows
    (the last perhaps fewer) that together cover every row once; a function of the shape
    alone (not of the rows' alignment), and the plan's steps take each of a block's rows
    once."""
    for d, es in ((768, 2), (1600, 2), (4096, 4), (37, 2)):
        plans = {krms.backward_plan(rows, d, es, aligned) for aligned in (True, False)}
        assert len({p[4:] for p in plans}) == 1
        for plan in plans:
            per, blocks = plan.rows_per_block, plan.blocks
            held = krms.backward_plan(rows, d, es).vectors * krms.backward_plan(rows, d, es).unit
            cap = krms.BACKWARD_BLOCKS if held <= krms.HELD else krms.BACKWARD_BLOCKS // 2
            assert blocks == krms.backward_blocks(rows, d, es) and 1 <= blocks <= min(rows, cap)
            runs = [range(b * per, min(rows, (b + 1) * per)) for b in range(blocks)]
            assert all(len(r) > 0 for r in runs)
            assert sorted(i for r in runs for i in r) == list(range(rows))
            steps = -(-per // plan.teams)
            taken = sorted(k * plan.teams + t for k in range(steps) for t in range(plan.teams)
                           if k * plan.teams + t < per)
            assert taken == list(range(per))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bfloat16", "float32"])
@pytest.mark.parametrize("d", [768, 1536, 1600, 2048, 3200, 4096])
def test_rmsnorm_backward_plan_fills_every_thread_at_the_training_widths(d, dtype):
    """At every training width each thread of a row's team holds the same number of 16-byte
    units and none idles (team x units x unit = D); a team is whole groups of 8 lanes, a
    block whole groups of 8 of at most ``BACKWARD_THREADS``, its teams' column sums within the
    shared memory it may use; the split has the most threads a block of those that hold at
    most ``MAX_HELD`` elements a thread, and holds at most ``HELD`` where such a split has as
    many threads. Rows that are not 16-byte aligned take single elements."""
    es = torch.empty((), dtype=dtype).element_size()
    plan = krms.backward_plan(8192, d, es)
    assert plan.unit == 16 // es and plan.team * plan.vectors * plan.unit == d
    assert plan.vectors in krms.VECTORS[True] and plan.team % 8 == 0
    threads = plan.team * plan.teams
    assert threads % 8 == 0 and threads <= krms.BACKWARD_THREADS
    assert 4 * plan.teams * d <= krms.SMEM_BYTES
    splits = [(v, plan.unit * v, (d // plan.unit // v) * krms._teams(d // plan.unit // v))
              for v in krms.VECTORS[True] if (d // plan.unit) % v == 0
              and (d // plan.unit // v) % 8 == 0 and krms._teams(d // plan.unit // v)]
    most = max(t for _, held, t in splits if held <= krms.MAX_HELD)
    assert threads == most and plan.vectors * plan.unit <= krms.MAX_HELD
    if any(t == most and held <= krms.HELD for _, held, t in splits):
        assert plan.vectors * plan.unit <= krms.HELD
    odd = krms.backward_plan(8192, d, es, aligned=False)
    assert odd.unit == 1 and odd.team * odd.vectors >= d and odd.vectors in krms.VECTORS[False]


def test_rmsnorm_backward_cost_is_its_formula():
    """8 operations an element; x, g and dx once, scale and dscale once."""
    for dt in (torch.float32, torch.bfloat16):
        x, s = torch.empty((3, 7, 40), dtype=dt, device="meta"), torch.empty(40, dtype=dt,
                                                                              device="meta")
        c = krms.backward_cost(x, s)
        assert c.flops == 8.0 * 3 * 7 * 40
        assert c.bytes == (3 * 3 * 7 * 40 + 2 * 40) * x.element_size()


# -------------------------------------------------------- the Functions' scopes
def _rms_case():
    rng = np.random.default_rng(3)
    (_, x), (_, s), (_, g) = (_pair(rng, sh) for sh in ((2, 9, 16), (16,), (2, 9, 16)))
    return ((x, s), g, lambda *t: ops.rmsnorm(*t),
            lambda m: (krms.cost(*m), krms.backward_cost(*m)),
            lambda: krms.plain_backward(x, s, g, 1e-5))


def _flash_case():
    (_, q), (_, k), (_, v), (_, g) = _flash_inputs((1, 40, 24, 4, 2, 8, True, 0), "float32")
    o = kfl.plain(q, k, v, causal=True)
    return ((q, k, v), g, lambda *t: ops.flash_attention(*t, causal=True),
            lambda m: (kfl.cost(*m, causal=True), kfl.backward_cost(*m, causal=True)),
            lambda: kfl.plain_backward(q, k, v, o, g, causal=True))


FUNCTION_CASES = {"rmsnorm": _rms_case, "flash_attention": _flash_case}


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("name", sorted(FUNCTION_CASES))
def test_each_backward_call_is_a_kernel_scope(name, device):
    """Under a ``CostCounter`` the backward counts once, as ``<name>_backward`` by its
    ``backward_cost``, on the CPU (``plain_backward``, bit for bit) and on ``meta``
    tensors (empty outputs of the gradients' shapes) alike; the forward by its ``cost``."""
    inputs, g, call, costs, formula = FUNCTION_CASES[name]()
    leaves = [t.to(device).requires_grad_(True) for t in inputs]
    g = g.to(device)
    with CostCounter() as counter:
        out = call(*leaves)
        grads = torch.autograd.grad(out, leaves, g)
    assert type(out.grad_fn).__name__ in ("RMSNormFunctionBackward",
                                         "FlashAttentionFunctionBackward")
    assert [(t.device.type, t.shape) for t in grads] == [(device, x.shape) for x in leaves]
    if device == "cpu":
        for a, b in zip(grads, formula()):
            assert torch.equal(a, b)
    fwd, bwd = costs([t.to("meta") for t in inputs])
    assert counter.kernels == {name: [1, fwd.flops, fwd.bytes],
                               f"{name}_backward": [1, bwd.flops, bwd.bytes]}
    assert counter.flops == fwd.flops + bwd.flops and counter.bytes == fwd.bytes + bwd.bytes


def test_the_flash_function_saves_the_forwards_lse_off_the_cpu():
    """On ``meta`` tensors (the card's route without a launch) the Function saves the
    forward kernel's logsumexp [B, Hq, Sq] beside q, k, v and o; on the CPU only those
    four (the formula recomputes P)."""
    shapes = ((2, 12, 4, 8), (2, 20, 2, 8), (2, 20, 2, 8))
    for device, extra in (("meta", [(2, 4, 12)]), ("cpu", [])):
        t = [torch.zeros(sh, device=device, requires_grad=True) for sh in shapes]
        o = kfl.FlashAttentionFunction.apply(*t, False, 0, None)
        got = [tuple(x.shape) for x in o.grad_fn.saved_tensors]
        assert got == [*shapes, shapes[0], *extra]
    o, lse = kfl.forward_with_lse(*(torch.empty(sh, device="meta") for sh in shapes))
    assert o.shape == shapes[0] and lse.shape == (2, 4, 12) and lse.dtype == torch.float32


def test_backward_wrappers_refuse_cpu_tensors_and_return_meta_shapes():
    """The backward wrappers launch on CUDA tensors only: a CPU tensor is refused (the
    Function takes the formula there), a ``meta`` one gets empty outputs."""
    q, k = torch.zeros((1, 16, 4, 8)), torch.zeros((1, 12, 2, 8))
    lse = torch.zeros((1, 4, 16))
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        kfl.backward(q, k, k, q, lse, q)
    meta = lambda *t: [x.to("meta") for x in t]
    out = kfl.backward(*meta(q, k, k, q, lse, q))
    assert [tuple(t.shape) for t in out] == [(1, 16, 4, 8), (1, 12, 2, 8), (1, 12, 2, 8)]
    x, s = torch.zeros((3, 5, 16)), torch.zeros(16)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        krms.backward(x, s, x)
    out = krms.backward(*meta(x, s, x))
    assert [tuple(t.shape) for t in out] == [(3, 5, 16), (16,)]


# ------------------------------------------------------------------ C entries
def test_backward_entries_have_their_ctypes_signatures():
    """Each forward entry of flash has its backward entry of the same (dtype, head_dim)
    split (14 pointers: the tensors, four workspaces and the work list; 6 ints, the scale,
    causal, window, the columns a row without a key averages over, the grid's blocks, the
    stream), the one-pass kernel's grid comes from
    ``flash_attention_backward_resident_blocks(dh)``, the forward entries take the optional
    lse pointer and V's mean for the rows that allow no key (with the count of columns it
    averages over), and rmsnorm's backward entries take 6 pointers, 8 ints (rows, d and the
    plan), eps and the stream; all as ``_build.SIGNATURES`` gives them."""
    ctype = {"const void*": _build._P, "void*": _build._P, "int": _build._I,
             "float": _build._F}
    P, I, F = _build._P, _build._I, _build._F
    want = {"flash_attention": {**{e: (P,) * 6 + (I,) * 6 + (F, I, I, I, P)
                                   for e in kfl._BACKWARD_ENTRY},
                                **{e: (P,) * 14 + (I,) * 6 + (F, I, I, I, I, P)
                                   for e in kfl._BACKWARD_ENTRY.values()},
                                "flash_attention_backward_resident_blocks": (I,)},
            "rmsnorm": {**{e: (P, P, P, I, I, F, P) for e in krms._ENTRY.values()},
                        **{e: (P,) * 6 + (I,) * 8 + (F, P)
                           for e in krms._BACKWARD_ENTRY.values()}}}
    assert set(kfl._BACKWARD_ENTRY) == {"flash_attention_f32", "flash_attention_bf16",
                                        "flash_attention_bf16_wgmma"}
    for lib, entries in want.items():
        src = (_build.CSRC / f"{lib}.cu").read_text()
        protos = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src))
        assert set(protos) == set(entries)
        for entry, types in entries.items():
            assert _build.SIGNATURES[lib][entry] == types, entry
            got = tuple(ctype[" ".join(p.split()[:-1])] for p in protos[entry].split(","))
            assert got == types, entry


@pytest.mark.parametrize("case", list(SCHEDULE_CASES), ids=str)
def test_one_pass_for_takes_the_one_pass_only_under_a_causal_sliding_window(case):
    """``one_pass_for``, the one place that picks the bf16 tensor-core backward's route: the
    one pass at head_dim 64 under a causal sliding window (hymba's sliding layers), the two
    kernels everywhere else (granite's head_dim 128, whisper's cross attention, any causal
    shape without a window); never for float32, where the CUDA-core kernel runs."""
    _, _, _, _, _, causal, window = SCHEDULE_CASES[case]
    for dh in (64, 128):
        want = dh == 64 and causal and window > 0
        assert kfl.one_pass_for(torch.bfloat16, dh, causal, window) is want
        assert kfl.one_pass_for(torch.float32, dh, causal, window) is False
    assert kfl.one_pass_for(torch.bfloat16, 64, *SCHEDULE_CASES["hymba sliding"][5:])
    assert not kfl.one_pass_for(torch.bfloat16, 128, *SCHEDULE_CASES["granite"][5:])


def test_the_backward_sources_name_their_kernels_and_hold_no_float_atomics():
    """The wgmma backward entry runs the one-pass tensor-core kernel at head_dim 64 when it
    is handed the ordered dQ sums (``acc``; the wrapper alone chooses, by ``one_pass_for``,
    and ``resident_blocks`` sizes that grid), else the two tensor-core kernels (dK/dV, then
    dQ) at head_dim 64 or 128; the others go to the CUDA-core one; neither source adds with
    atomics (a run repeats bitwise: ``chip_smoke.py`` phase 2 checks it on the card; the
    one-pass kernel's dQ sums wait their turn on flags)."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    assert kfl.WGMMA_HEAD_DIMS == (64, 128)
    for entry, call, want in (
            ("flash_attention_backward_bf16_wgmma", r"wg::launch_one_pass<(\d+)>\(", ["64"]),
            ("flash_attention_backward_bf16_wgmma", r"wg::launch_two_kernels<(\d+)>\(", ["64", "128"]),
            ("flash_attention_backward_resident_blocks", r"wg::resident_blocks<(\d+)>\(", ["64"])):
        body = src[src.index(f'extern "C" int {entry}('):]
        body = body[:body.index("\n}\n")]
        assert re.findall(call, body) == want, entry
    for entry in ("flash_attention_backward_f32", "flash_attention_backward_bf16"):
        body = src[src.index(f'extern "C" int {entry}('):]
        assert "simt::launch_backward<" in body[:body.index("\n}\n")]
    for name in ("flash_attention", "rmsnorm"):
        code = (_build.CSRC / f"{name}.cu").read_text()
        assert not re.search(r"\batomic\w*\(|\bred\.|\batom\.", code), name
