"""The backward kernels of ``moe_gmm`` and ``ssd``, host side, on the CPU.

``moe_gmm.plain_backward`` and ``ssd.plain_backward`` (the explicit gradient
formulas that the backward kernels compute, and that the ``autograd.Function``s
run on CPU tensors) against ``jax.vjp`` of the reference's ``moe_gmm`` and
``ssd_chunked``: rows masked past ``live`` in several groups with an expert that
has no live row; a non-zero final-state gradient, one chunk, three chunks and a
chunk longer than S. ``ssd.chunked_backward_reference`` (the backward kernel's
passes and workspaces in float32 PyTorch) against the formula. Each Function's
backward is the formula, not autograd of the forward; each backward call is a
kernel scope counted by its ``backward_cost``; the C entries have their ctypes
signatures. The launch itself runs only on the card (``chip_smoke.py`` phases 2
and 6). Inputs come from numpy seeds.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.models.ssm import ssd_chunked as jax_ssd_chunked  # noqa: E402
from repro_torch.bridge import to_numpy, to_tensor  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import moe_gmm as kgmm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd as kssd  # noqa: E402
from repro_torch.launch.hlo_counter import CostCounter  # noqa: E402

DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
SMS = 132  # an H100's streaming multiprocessors


def _tol(dtype):   # tests/test_kernels.py::_tol
    return dict(rtol=3e-2, atol=3e-2) if dtype == "bfloat16" else dict(rtol=2e-3, atol=2e-3)


def _pair(rng, shape, dtype, fn=lambda v: v):
    """One numpy-seeded array as a JAX array and a CPU tensor with the same bits."""
    j = jnp.asarray(fn(rng.standard_normal(shape)).astype(np.float32), DTYPES[dtype])
    return j, to_tensor(np.asarray(j), "cpu")


@pytest.fixture(autouse=True)
def _counters_stay_zero():
    """The CPU path launches nothing, forward or backward."""
    ops.reset_launch_counts()
    yield
    assert set(ops.launch_counts().values()) == {0}


# ------------------------------------------------------------------ moe_gmm
GMM_CASES = [  # (E, C, D, F, groups); expert 1 has no live row
    (4, 16, 32, 24, 1),
    (4, 24, 40, 48, 2),
    (6, 40, 100, 72, 4),
]


def _gmm_inputs(rng, e, c, d, f, groups, dtype):
    live = rng.integers(0, c // groups + 1, size=(e, groups)).astype(np.int32)
    live[0, 0], live[1], live[-1, -1] = 0, 0, c // groups
    xj, xt = _pair(rng, (e, c, d), dtype)
    wj, wt = _pair(rng, (e, d, f), dtype, lambda v: v * d**-0.5)
    gj, gt = _pair(rng, (e, c, f), dtype)
    return live, (xj, xt), (wj, wt), (gj, gt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GMM_CASES, ids=lambda c: "e{}-c{}-d{}-f{}-g{}".format(*c))
def test_moe_gmm_plain_backward_matches_reference_vjp(case, dtype):
    """dxe and dwe against ``jax.vjp`` of ``ref.moe_gmm`` on xe masked past ``live``;
    what lies past ``live`` in xe and dout (NaN here) is never read, and dxe is
    exactly zero there."""
    e, c, d, f, groups = case
    live, (xj, xt), (wj, wt), (gj, gt) = _gmm_inputs(np.random.default_rng(21), e, c, d, f,
                                                     groups, dtype)
    live_t = torch.from_numpy(live)
    mask = kgmm.live_rows(live_t, c)
    mask_j = jnp.asarray(mask.numpy())[..., None]
    _, vjp = jax.vjp(lambda x, w: jref.moe_gmm(jnp.where(mask_j, x, 0).astype(x.dtype), w), xj, wj)
    dx_want, dw_want = vjp(gj)
    nan = torch.tensor(float("nan"), dtype=xt.dtype)
    dx, dw = kgmm.plain_backward(torch.where(mask[..., None], xt, nan), wt, live_t,
                                 torch.where(mask[..., None], gt, nan))
    assert dx.dtype == xt.dtype and dw.dtype == wt.dtype
    assert tuple(dx.shape) == (e, c, d) and tuple(dw.shape) == (e, d, f)
    assert not dx[~mask].any() and not dw[1].any()
    np.testing.assert_allclose(to_numpy(dx), np.asarray(dx_want, np.float32), **_tol(dtype))
    np.testing.assert_allclose(to_numpy(dw), np.asarray(dw_want, np.float32), **_tol(dtype))


def test_moe_gmm_plain_backward_without_live_is_every_row():
    rng = np.random.default_rng(22)
    _, (_, xt), (_, wt), (_, gt) = _gmm_inputs(rng, 3, 8, 16, 12, 1, "float32")
    got = kgmm.plain_backward(xt, wt, None, gt)
    x, w = xt.clone().requires_grad_(True), wt.clone().requires_grad_(True)
    want = torch.autograd.grad(torch.einsum("ecd,edf->ecf", x, w), (x, w), gt)
    for g, ww in zip(got, want):
        np.testing.assert_allclose(g.numpy(), ww.numpy(), rtol=1e-5, atol=1e-5)


def test_moe_gmm_backward_cost_counts_the_live_rows():
    """4·D·F a live row; xe's and dout's live rows, the live experts' weights read,
    dxe and dwe written whole."""
    xe, we = torch.empty((4, 16, 32), device="meta"), torch.empty((4, 32, 24), device="meta")
    c = kgmm.backward_cost(xe, we, rows=20, experts=3)
    assert c.flops == 4.0 * 20 * 32 * 24
    assert c.bytes == 4.0 * (20 * (32 + 24) + 3 * 32 * 24 + 4 * 16 * 32 + 4 * 32 * 24)
    full = kgmm.backward_cost(xe, we)
    assert full.flops == 2 * kgmm.cost(xe, we).flops


# the training shapes (chip_smoke.py's TRAIN_GMM_CASES), ragged ones and a narrow one
PLAN_SHAPES = [(64, 1280, 2048, 1024), (64, 1280, 1024, 2048), (128, 640, 4096, 1536),
               (8, 40, 100, 72), (3, 300, 64, 136), (16, 256, 512, 300), (1, 1, 1, 1),
               (2, 129, 257, 255)]
SMEM_LIMIT = 232448  # bytes a block may hold on an H100 (227 KB)


def _bwd_source():
    src = (_build.CSRC / "moe_gmm.cu").read_text()
    return src[src.index("namespace tc {"):src.index("}  // namespace tc")]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda c: "e{}-r{}-d{}-f{}".format(*c))
def test_backward_tile_plan_covers_every_output_tile_once(shape):
    """Each product's grid of 128-row, BN-column tiles covers its output [rows, d] (dX)
    or [d, f] (dW) exactly once per expert, with a BN the source instantiates."""
    e, r, d, f = shape
    plan = kgmm.backward_tile_plan(r, d, f)
    src = _bwd_source()
    for kind, (m, n) in (("dx", (r, d)), ("dw", (d, f))):
        bn, (gx, gy) = plan[kind]
        assert f"launch_product<k{kind.upper()}, {bn}>" in src
        assert bn == (256 if n >= 256 else 128)
        owner = np.zeros((m, n), int)
        for by in range(gy):
            for bx in range(gx):
                owner[by * kgmm.BACKWARD_BLOCK_ROWS:(by + 1) * kgmm.BACKWARD_BLOCK_ROWS,
                      bx * bn:(bx + 1) * bn] += 1
        assert (owner == 1).all(), kind
        assert gy <= 65535


def test_backward_tiles_fit_shared_memory_as_the_source_lays_them_out():
    """The ring (4 stages of a 128 x 64 and a BN x 64 bf16 tile, 1 KB of alignment) and
    the row flags fit a block's 227 KB, for both BN; the source's constants are the
    ones the plan assumes, and the epilogue's bf16 tile fits in the ring."""
    src = _bwd_source()
    const = {name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
             for name in ("kBM", "kBK", "kStages")}
    assert const["kBM"] == kgmm.BACKWARD_BLOCK_ROWS == 128
    assert "kSmemBytes = kStages * kStage + 1024" in src
    for bn in (128, 256):
        ring = const["kStages"] * (const["kBM"] + bn) * const["kBK"] * 2  # bf16 A and B tiles
        assert ring + 1024 + 128 <= SMEM_LIMIT   # + alignment slack, s_live (a flag a row)
        assert const["kBM"] * (bn + 8) * 2 <= ring  # the epilogue's bf16 tile


@pytest.mark.parametrize("shape", PLAN_SHAPES[:3], ids=lambda c: "e{}-r{}-d{}-f{}".format(*c))
def test_backward_tile_plan_fills_the_card_at_the_training_shapes(shape):
    """At the training micro-batch's shapes each product has at least ten blocks an SM
    (one block fits an SM at a time): the last wave's tail is under a tenth."""
    e, r, d, f = shape
    for bn, (gx, gy) in kgmm.backward_tile_plan(r, d, f).values():
        assert e * gx * gy >= 10 * SMS


# ---------------------------------------------------------------------- ssd
SSD_CASES = [  # (B, S, H, P, N, chunk): one chunk, three chunks, a chunk longer than S
    (2, 16, 2, 8, 4, 16),
    (2, 48, 3, 8, 4, 16),
    (1, 32, 2, 5, 7, 64),
    (2, 64, 3, 16, 8, 16),
]


def _ssd_inputs(rng, b, s, h, p, n, dtype="float32"):
    """tests/test_kernels.py::test_ssd_kernel's distributions, plus dy and dhf."""
    return (_pair(rng, (b, s, h, p), dtype, lambda v: v * 0.5),
            _pair(rng, (b, s, h), "float32", lambda v: -np.abs(v) * 0.3),
            _pair(rng, (b, s, n), dtype, lambda v: v * 0.5),
            _pair(rng, (b, s, n), dtype, lambda v: v * 0.5),
            _pair(rng, (b, s, h, p), dtype),
            _pair(rng, (b, h, p, n), "float32", lambda v: v * 0.5))


@pytest.mark.parametrize("with_dhf", [True, False], ids=["dhf", "no-dhf"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SSD_CASES, ids=lambda c: "b{}-s{}-h{}-p{}-n{}-l{}".format(*c))
def test_ssd_plain_backward_matches_reference_vjp(case, dtype, with_dhf):
    """(dx, da, db, dc) against ``jax.vjp`` of ``ssd_chunked`` for the gradients of y and
    of the final state (zero without ``dhf``); db and dc sum over the heads."""
    b, s, h, p, n, chunk = case
    (xj, xt), (aj, at), (bj, bt), (cj, ct), (gj, gt), (hj, ht) = _ssd_inputs(
        np.random.default_rng(31), b, s, h, p, n, dtype)
    if not with_dhf:
        hj, ht = jnp.zeros_like(hj), None
    l = min(chunk, s)
    _, vjp = jax.vjp(lambda *t: jax_ssd_chunked(*t, l), xj, aj, bj, cj)
    want = vjp((gj, hj))
    got = kssd.plain_backward(xt, at, bt, ct, gt, ht, chunk)
    for name, g, w, t in zip(("dx", "da", "db", "dc"), got, want, (xt, at, bt, ct)):
        assert g.dtype == t.dtype and g.shape == t.shape, name
        w = np.asarray(w, np.float32)
        # da, db and dc sum over a chunk's steps (and db, dc over the heads): relative to
        # their largest entry
        top = 1.0 if name == "dx" else np.abs(w).max()
        np.testing.assert_allclose(to_numpy(g) / top, w / top, err_msg=name, **_tol(dtype))


@pytest.mark.parametrize("with_dhf", [True, False], ids=["dhf", "no-dhf"])
@pytest.mark.parametrize("case", SSD_CASES, ids=lambda c: "b{}-s{}-h{}-p{}-n{}-l{}".format(*c))
def test_chunked_backward_reference_equals_the_formula(case, with_dhf):
    """The kernel's passes (the gradient of cum from dy·y - x·dx, db and dc from the
    heads' V summed first) against the explicit formula, in float32; its workspace holds
    the gradient of the state leaving each chunk (dhf for the last)."""
    b, s, h, p, n, chunk = case
    (_, xt), (_, at), (_, bt), (_, ct), (_, gt), (_, ht) = _ssd_inputs(
        np.random.default_rng(32), b, s, h, p, n)
    ht = ht if with_dhf else None
    l = min(chunk, s)
    ws = kssd.backward_workspaces(b, s, h, p, n, l, torch.device("cpu"))
    assert [tuple(t.shape) for t in ws] == [(b, s // l, h, p, n)]
    got = kssd.chunked_backward_reference(xt, at, bt, ct, gt, ht, chunk, ws=ws)
    want = kssd.plain_backward(xt, at, bt, ct, gt, ht, chunk)
    for name, g, w in zip(("dx", "da", "db", "dc"), got, want):
        top = np.abs(w.numpy()).max()
        np.testing.assert_allclose(g.numpy() / top, w.numpy() / top, rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    (dstates,) = ws
    last = torch.zeros((b, h, p, n)) if ht is None else ht
    np.testing.assert_allclose(dstates[:, -1].numpy(), last.numpy())


def test_round_tf32_is_round_to_nearest_ties_away():
    """``round_tf32`` keeps 10 mantissa bits as ``cvt.rna.tf32.f32`` does: halfway
    values go away from zero, either sign; bf16 values pass unchanged. ``tf32_parts``
    splits a float32 into two TF32 numbers whose sum keeps 21 bits of it."""
    ulp = 2.0 ** -10
    t = torch.tensor([1.0, 1 + ulp / 2, 1 + 1.5 * ulp, -(1 + ulp / 2), 1 + ulp / 4, 3.14159265])
    want = [1.0, 1 + ulp, 1 + 2 * ulp, -(1 + ulp), 1.0, 3.140625]
    assert kssd.round_tf32(t).tolist() == want
    v = torch.randn(1000).to(torch.bfloat16).float()
    assert torch.equal(kssd.round_tf32(v), v)
    w = torch.randn(1000) * 100
    assert ((kssd.round_tf32(w) - w).abs() <= w.abs() * 2.0 ** -11).all()
    hi, lo = kssd.tf32_parts(w)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()  # 13 low mantissa bits clear
    assert ((hi + lo - w).abs() <= w.abs() * 2.0 ** -21).all()
    assert (lo != 0).any()


# the SSD_CASES and mamba2-130m's widths (P 64, N 128, chunk 128) over two chunks
TF32_CASES = SSD_CASES + [(1, 256, 2, 64, 128, 128)]


@pytest.mark.parametrize("with_dhf", [True, False], ids=["dhf", "no-dhf"])
@pytest.mark.parametrize("case", TF32_CASES, ids=lambda c: "b{}-s{}-h{}-p{}-n{}-l{}".format(*c))
def test_chunked_backward_reference_with_tf32_operands_holds_the_bf16_tolerance(case, with_dhf):
    """The bf16 kernel's passes with its tensor-core operands as it forms them (each
    float32 intermediate as two TF32 parts), emulated in float32 (``tf32=True``), on
    bf16 inputs: within the bf16 ``_tol`` of the float32 formula and of ``jax.vjp`` of
    ``ssd_chunked``, and within 1e-4 of the unrounded passes (relative to each
    output's largest entry): the parts keep float32's accuracy."""
    b, s, h, p, n, chunk = case
    (xj, xt), (aj, at), (bj, bt), (cj, ct), (gj, gt), (hj, ht) = _ssd_inputs(
        np.random.default_rng(34), b, s, h, p, n, "bfloat16")
    if not with_dhf:
        hj, ht = jnp.zeros_like(hj), None
    l = min(chunk, s)
    got = kssd.chunked_backward_reference(xt, at, bt, ct, gt, ht, chunk, tf32=True)
    exact = kssd.chunked_backward_reference(xt, at, bt, ct, gt, ht, chunk)
    formula = kssd.plain_backward(xt, at, bt, ct, gt, ht, chunk)
    _, vjp = jax.vjp(lambda *t: jax_ssd_chunked(*t, l), xj, aj, bj, cj)
    ref = vjp((gj, hj))
    for name, g, w, r, e in zip(("dx", "da", "db", "dc"), got, formula, ref, exact):
        w, r = to_numpy(w).astype(np.float32), np.asarray(r, np.float32)
        top = 1.0 if name == "dx" else np.abs(w).max()
        if name == "da":  # dx, db and dc are rounded to bf16, da float32
            np.testing.assert_allclose(g.numpy() / top, e.numpy() / top, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(to_numpy(g) / top, w / top, err_msg=name, **_tol("bfloat16"))
        np.testing.assert_allclose(to_numpy(g) / top, r / top, err_msg=name, **_tol("bfloat16"))


def test_chunked_backward_reference_takes_the_forwards_workspaces():
    """Given the workspaces ``chunked_reference`` fills (as the forward kernel leaves
    them) and its final state, the backward equals the one that computes them itself."""
    b, s, h, p, n, l = 2, 64, 3, 8, 4, 16
    (_, xt), (_, at), (_, bt), (_, ct), (_, gt), (_, ht) = _ssd_inputs(
        np.random.default_rng(33), b, s, h, p, n)
    fws = kssd.workspaces(b, s, h, p, n, l, torch.device("cpu"))
    _, hf = kssd.chunked_reference(xt, at, bt, ct, l, fws)
    got = kssd.chunked_backward_reference(xt, at, bt, ct, gt, ht, l, saved=(*fws, hf))
    want = kssd.chunked_backward_reference(xt, at, bt, ct, gt, ht, l)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_ssd_backward_cost_counts_the_causal_pairs():
    b, s, h, p, n, l = 2, 64, 3, 8, 4, 16
    x, a = torch.empty((b, s, h, p), device="meta"), torch.empty((b, s, h), device="meta")
    bm = torch.empty((b, s, n), device="meta")
    c = kssd.backward_cost(x, a, bm, bm, chunk=l, dhf=True)
    nc = s // l
    assert c.flops == b * nc * h * (l * (l + 1) * (2 * p + 2 * n) + 8 * l * p * n)
    assert c.bytes == 4 * (3 * b * s * h * p + 4 * b * s * n + 2 * b * s * h
                           + b * nc * h * (p * n + 1) + b * nc * l * l + 2 * b * h * p * n)
    assert kssd.backward_cost(x, a, bm, bm, chunk=l).bytes == c.bytes - 4 * b * h * p * n


# ------------------------------------------------------- the autograd Functions
def _gmm_function_case():
    live, (_, xt), (_, wt), (_, gt) = _gmm_inputs(np.random.default_rng(41), 4, 24, 40, 48, 2,
                                                  "float32")
    live_t = torch.from_numpy(live)
    xt = xt * kgmm.live_rows(live_t, 24)[..., None]
    run = lambda x, w: kgmm.MoeGmmFunction.apply(x, w, live_t)
    plain = lambda x, w: kgmm.plain(x, w, live_t)
    formula = lambda: kgmm.plain_backward(xt, wt, live_t, gt)
    return (xt, wt), gt, run, plain, formula, "MoeGmmFunctionBackward"


def _ssd_function_case():
    (_, xt), (_, at), (_, bt), (_, ct), (_, gt), (_, ht) = _ssd_inputs(
        np.random.default_rng(42), 2, 48, 3, 8, 4)
    run = lambda *t: kssd.SSDFunction.apply(*t, 16)[0]
    plain = lambda *t: kssd.plain(*t, 16)[0]
    formula = lambda: kssd.plain_backward(xt, at, bt, ct, gt, None, 16)
    return (xt, at, bt, ct), gt, run, plain, formula, "SSDFunctionBackward"


FUNCTION_CASES = {"moe_gmm": _gmm_function_case, "ssd": _ssd_function_case}


@pytest.mark.parametrize("name", sorted(FUNCTION_CASES))
def test_backward_is_the_formula_not_a_differentiated_forward(name):
    """The Function's gradient is ``plain_backward``'s, bit for bit; the formula records
    no graph under ``no_grad``; and it equals autograd of the plain forward."""
    inputs, g, run, plain, formula, fn_name = FUNCTION_CASES[name]()
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    out = run(*leaves)
    assert type(out.grad_fn).__name__ == fn_name
    got = torch.autograd.grad(out, leaves, g)
    want = formula()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with torch.no_grad():
        assert all(t.grad_fn is None for t in formula())
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    auto = torch.autograd.grad(plain(*leaves), leaves, g)
    for a, b in zip(got, auto):
        top = b.abs().max().item()
        np.testing.assert_allclose(a.numpy() / top, b.numpy() / top, **_tol("float32"))


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("name", sorted(FUNCTION_CASES))
def test_each_backward_call_is_a_kernel_scope(name, device):
    """Under a ``CostCounter`` the backward counts once, as ``<name>_backward`` by its
    ``backward_cost``, on the CPU (the formula) and on ``meta`` tensors (empty outputs)
    alike; the forward counts by its ``cost``."""
    inputs, g, *_ = FUNCTION_CASES[name]()
    leaves = [t.to(device).requires_grad_(True) for t in inputs]
    g = g.to(device)
    with CostCounter() as counter:
        out = ops.moe_gmm(*leaves) if name == "moe_gmm" else ops.ssd(*leaves, chunk=16)[0]
        grads = torch.autograd.grad(out, leaves, g)
    assert all(t.device.type == device and t.shape == x.shape for t, x in zip(grads, leaves))
    meta = [t.to("meta") for t in inputs]
    if name == "moe_gmm":
        fwd, bwd = kgmm.cost(*meta), kgmm.backward_cost(*meta)
    else:
        fwd, bwd = kssd.cost(*meta, chunk=16), kssd.backward_cost(*meta, chunk=16)
    assert counter.kernels == {name: [1, fwd.flops, fwd.bytes],
                               f"{name}_backward": [1, bwd.flops, bwd.bytes]}
    assert counter.flops == fwd.flops + bwd.flops and counter.bytes == fwd.bytes + bwd.bytes


def test_the_functions_save_what_their_backward_reads():
    """On ``meta`` tensors (the card's route without a launch) ``SSDFunction`` saves the
    forward kernel's three workspaces and the final state beside its inputs; on the
    CPU only the inputs (the formula recomputes the states)."""
    b, s, h, p, n, l = 2, 64, 3, 8, 4, 16
    shapes = ((b, s, h, p), (b, s, h), (b, s, n), (b, s, n))
    for device, saved in (("meta", [(b, s // l, h, p, n), (b, s // l, l, l), (b, s // l, h),
                                    (b, h, p, n)]), ("cpu", [])):
        t = [torch.zeros(sh, device=device, requires_grad=True) for sh in shapes]
        y, _ = kssd.SSDFunction.apply(*t, l)
        got = [tuple(x.shape) for x in y.grad_fn.saved_tensors]
        assert got == [*shapes, *saved]


def test_backward_entries_have_their_ctypes_signatures():
    """The wrappers' backward entries are C entries of their sources with the
    signatures ``_build.SIGNATURES`` gives them (``moe_gmm``: 6 pointers, 5 ints, and
    in bf16 the two products' block columns; ``ssd``: 15 pointers (one workspace), 6
    ints; each then the stream)."""
    ctype = {"const void*": _build._P, "void*": _build._P, "int": _build._I}
    ints = {("moe_gmm", torch.float32): 5, ("moe_gmm", torch.bfloat16): 7}
    for lib, entries, n_ptr in (("moe_gmm", kgmm._BACKWARD_ENTRY, 6),
                                ("ssd", kssd._BACKWARD_ENTRY, 15)):
        src = (_build.CSRC / f"{lib}.cu").read_text()
        protos = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src))
        assert set(entries) == {torch.float32, torch.bfloat16}
        for dtype, entry in entries.items():
            n_int = ints.get((lib, dtype), 6)
            want = (_build._P,) * n_ptr + (_build._I,) * n_int + (_build._P,)
            assert _build.SIGNATURES[lib][entry] == want, entry
            types = tuple(ctype[" ".join(q.split()[:-1])] for q in protos[entry].split(","))
            assert types == want, entry


def test_backward_wrappers_refuse_cpu_tensors_and_return_meta_shapes():
    """``backward`` launches on CUDA tensors only: a CPU tensor is refused (the
    Function takes the formula there), a ``meta`` one gets empty outputs."""
    xe, we, g = torch.zeros((2, 8, 16)), torch.zeros((2, 16, 4)), torch.zeros((2, 8, 4))
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        kgmm.backward(xe, we, None, g)
    out = kgmm.backward(xe.to("meta"), we.to("meta"), None, g.to("meta"))
    assert [tuple(t.shape) for t in out] == [(2, 8, 16), (2, 16, 4)]
    x, a, bm = torch.zeros((1, 16, 2, 8)), torch.zeros((1, 16, 2)), torch.zeros((1, 16, 4))
    ws = kssd.workspaces(1, 16, 2, 8, 4, 8, torch.device("cpu"))
    hf = torch.zeros((1, 2, 8, 4))
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        kssd.backward(x, a, bm, bm, x, None, *ws, hf, chunk=8)
    meta = [t.to("meta") for t in (x, a, bm, bm, x)]
    out = kssd.backward(*meta, None, *(t.to("meta") for t in ws), hf.to("meta"), chunk=8)
    assert [tuple(t.shape) for t in out] == [(1, 16, 2, 8), (1, 16, 2), (1, 16, 4), (1, 16, 4)]
