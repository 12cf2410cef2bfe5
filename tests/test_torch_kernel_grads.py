"""The gradients of the two kernels on the training path, and the kernels
without one.

``rmsnorm_backward`` and ``flash_attention_backward`` (the gradient formulas
that the kernels' ``autograd.Function``s run in their backward) against
``jax.vjp`` of the reference's ``rms_norm`` and ``chunked_attention``:
causal, windowed and non-causal with Sq != Sk, GQA groups of 1, 4 and 16.
The ``autograd.Function``s wired through the model under every remat
policy, with the kernel launch swapped for the plain version (the launch
runs only on the card: ``chip_smoke.py`` phase 6); and ``decode_attention``,
``moe_gmm`` and ``ssd`` refusing autograd on CUDA rather than dropping a
gradient, and every kernel's gradient on ``meta`` tensors (the dry-run).
Inputs come from numpy seeds; everything runs on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models.attention import chunked_attention as jax_chunked_attention  # noqa: E402
from repro.models.model import build as jax_build  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels import flash_attention as kfl  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rmsnorm as krms  # noqa: E402
from repro_torch.models.common import tree_items  # noqa: E402
from repro_torch.models.model import build  # noqa: E402

DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _tol(dtype):   # tests/test_kernels.py::_tol
    return dict(rtol=3e-2, atol=3e-2) if dtype == "bfloat16" else dict(rtol=2e-3, atol=2e-3)


def _pair(rng, shape, dtype="float32", scale=1.0):
    """One numpy-seeded array as a JAX array and a CPU tensor with the same bits."""
    j = jnp.asarray((scale * rng.standard_normal(shape)).astype(np.float32), DTYPES[dtype])
    return j, bridge.to_tensor(np.asarray(j), "cpu")


def _batch(cfg, seed=0, b=2, s=32):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((b, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal((b, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return batch


def _loss_and_grads(api, params, batch, **kw):
    leaves = [t.requires_grad_(True) for _, t in tree_items(params)]
    loss = api.train_loss(params, {k: torch.from_numpy(v) for k, v in batch.items()}, **kw)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), dict(zip((p for p, _ in tree_items(params)), grads))


def _models(arch):
    jparams = jax_build(jax_get_smoke(arch).replace(dtype="float32")).init_params(
        jax.random.PRNGKey(0))
    api = build(get_smoke(arch).replace(dtype="float32"), device="cpu")
    return api, bridge.from_numpy_tree(jax.tree_util.tree_map(np.asarray, jparams), "cpu")


@pytest.fixture(autouse=True)
def _counters_stay_zero():
    """The CPU path launches nothing."""
    ops.reset_launch_counts()
    yield
    assert set(ops.launch_counts().values()) == {0}


# --------------------------------------------------- the kernels' gradients
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 128), (2, 37, 64)])
def test_rmsnorm_backward_matches_reference_vjp(shape, dtype):
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng, shape, dtype)
    sj, st = _pair(rng, shape[-1:], dtype)
    gj, gt = _pair(rng, shape, dtype)
    _, vjp = jax.vjp(lambda x, s: jax_layers.rms_norm(x, s, 1e-5), xj, sj)
    dx_want, ds_want = vjp(gj)
    dx, ds = krms.rmsnorm_backward(xt, st, gt, 1e-5)
    assert dx.dtype == xt.dtype and ds.dtype == st.dtype
    np.testing.assert_allclose(bridge.to_numpy(dx), np.asarray(dx_want, np.float32), **_tol(dtype))
    # dscale sums a column over every row: relative to its largest entry
    ds_want = np.asarray(ds_want, np.float32)
    np.testing.assert_allclose(bridge.to_numpy(ds) / np.abs(ds_want).max(),
                               ds_want / np.abs(ds_want).max(), **_tol(dtype))


FLASH_CASES = [  # (Sq, Sk, Hq, Hkv, causal, window): G = Hq / Hkv of 1, 4 and 16
    (64, 64, 4, 4, True, 0),
    (64, 64, 8, 2, True, 0),
    (80, 80, 16, 1, True, 0),
    (96, 96, 8, 2, True, 24),
    (48, 112, 4, 4, False, 0),
    (112, 48, 8, 2, False, 0),
    (40, 72, 16, 1, True, 0),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "sq{}-sk{}-h{}x{}-{}-w{}".format(
    c[0], c[1], c[2], c[3], "causal" if c[4] else "full", c[5]))
def test_flash_attention_backward_matches_reference_vjp(case, dtype, monkeypatch):
    sq, sk, hq, hkv, causal, window = case
    # small blocks: several query blocks, each reading only the keys its mask allows
    monkeypatch.setattr(kfl, "BACKWARD_BLOCK_BYTES", 4 * 2 * hq * sk * 16)
    rng = np.random.default_rng(2)
    qj, qt = _pair(rng, (2, sq, hq, 32), dtype)
    kj, kt = _pair(rng, (2, sk, hkv, 32), dtype)
    vj, vt = _pair(rng, (2, sk, hkv, 32), dtype)
    doj, dot = _pair(rng, (2, sq, hq, 32), dtype)
    f = lambda q, k, v: jax_chunked_attention(q, k, v, causal=causal, window=window,
                                              q_block=32, kv_block=32)
    out, want = jax.jit(lambda q, k, v, do: (f(q, k, v), jax.vjp(f, q, k, v)[1](do)))(qj, kj, vj, doj)
    o = bridge.to_tensor(np.asarray(out), "cpu")
    got = kfl.flash_attention_backward(qt, kt, vt, o, dot, causal=causal, window=window)
    for name, g, w, t in zip("qkv", got, want, (qt, kt, vt)):
        assert g.dtype == t.dtype and g.shape == t.shape and g.is_contiguous(), name
        np.testing.assert_allclose(bridge.to_numpy(g), np.asarray(w, np.float32),
                                   err_msg=f"d{name}", **_tol(dtype))


def test_backward_is_the_formula_not_a_differentiated_forward():
    """``flash_attention_backward`` runs under ``no_grad`` as well: it records no graph."""
    rng = np.random.default_rng(4)
    q, k, v, do = (_pair(rng, (1, 16, 2, 8))[1] for _ in range(4))
    o = kfl.plain(q, k, v, causal=True)
    with torch.no_grad():
        got = kfl.flash_attention_backward(q, k, v, o, do, causal=True)
    for t in got:
        assert t.grad_fn is None
    q2, k2, v2 = (t.clone().requires_grad_(True) for t in (q, k, v))
    want = torch.autograd.grad(kfl.plain(q2, k2, v2, causal=True), (q2, k2, v2), do)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **_tol("float32"))


@pytest.fixture
def functions_on_cpu(monkeypatch):
    """``enable()`` routes ``ops.rmsnorm`` and ``ops.flash_attention`` through their
    ``autograd.Function``s on CPU tensors, with the kernel launch swapped for the
    plain version (the launch itself runs only on the card); the returned dict
    counts the calls."""
    calls = {"rmsnorm": 0, "flash_attention": 0}

    def rms(x, scale, *, eps=1e-5):
        calls["rmsnorm"] += 1
        return krms.RMSNormFunction.apply(x, scale, eps)

    def flash(q, k, v, *, causal=True, window=0, scale=None):
        calls["flash_attention"] += 1
        return kfl.FlashAttentionFunction.apply(q, k, v, causal, window, scale)

    def enable():
        monkeypatch.setattr(krms, "rmsnorm", lambda x, s, eps=1e-5: krms.plain(x, s, eps))
        monkeypatch.setattr(kfl, "flash_attention", lambda q, k, v, *, causal, window, scale:
                            kfl.plain(q, k, v, causal=causal, window=window, scale=scale))
        monkeypatch.setattr(ops, "rmsnorm", rms)
        monkeypatch.setattr(ops, "flash_attention", flash)
        return calls

    return enable


@pytest.mark.parametrize("arch,remat", [("granite-8b", "none"), ("granite-8b", "full"),
                                        ("granite-8b", "dots"), ("hymba-1.5b", "full"),
                                        ("whisper-base", "none")])
def test_kernel_functions_carry_the_model_gradient(arch, remat, functions_on_cpu):
    """Through the two ``autograd.Function``s (granite: 2L+1 norms and L flash calls;
    hymba: a sliding window and the SSM branch; whisper: non-causal flash with
    Sq != Sk) the loss and every leaf's gradient equal those of the plain path.
    "full" and "dots" recompute each block's norms and attention in the backward."""
    api, params = _models(arch)
    batch = _batch(api.cfg)
    plain_loss, plain_grads = _loss_and_grads(api, params, batch, remat="none")
    calls = functions_on_cpu()
    loss, grads = _loss_and_grads(api, params, batch, remat=remat)
    np.testing.assert_allclose(loss.item(), plain_loss.item(), **_tol("float32"))
    for path, g in grads.items():
        w = plain_grads[path].numpy()
        top = max(np.abs(w).max(), 1e-30)
        np.testing.assert_allclose(g.numpy() / top, w / top, err_msg=path, **_tol("float32"))
    L = api.cfg.num_layers
    redo = remat != "none"
    want = {"granite-8b": {"rmsnorm": 2 * L + 1 + redo * 2 * L, "flash_attention": L + redo * L},
            "hymba-1.5b": {"rmsnorm": 5 * L + 1 + redo * 5 * L, "flash_attention": L + redo * L},
            # the encoder-decoder has no rmsnorm and no remat: 1 + 2 flash calls a layer
            "whisper-base": {"rmsnorm": 0,
                             "flash_attention": api.cfg.encoder_layers + 2 * L}}[arch]
    assert calls == want


def _meta(*shape, dtype=torch.float32, grad=True, device="meta"):
    return torch.empty(shape, dtype=dtype, device=device, requires_grad=grad)


KERNEL_CALLS = {   # each kernel's entry point on tensors of a device that require grad
    "rmsnorm": lambda dev: ops.rmsnorm(_meta(2, 8, device=dev), _meta(8, device=dev)),
    "flash_attention": lambda dev: ops.flash_attention(*(_meta(1, 4, 2, 8, device=dev)
                                                         for _ in range(3))),
    "decode_attention": lambda dev: ops.decode_attention(
        _meta(2, 4, 8, device=dev), _meta(2, 16, 2, 8, device=dev),
        _meta(2, 16, 2, 8, device=dev), _meta(2, 16, dtype=torch.int32, grad=False, device=dev),
        _meta(2, dtype=torch.int32, grad=False, device=dev)),
    "moe_gmm": lambda dev: ops.moe_gmm(_meta(4, 8, 16, device=dev), _meta(4, 16, 8, device=dev)),
    "ssd": lambda dev: ops.ssd(_meta(1, 16, 2, 8, device=dev), _meta(1, 16, 2, device=dev),
                               _meta(1, 16, 4, device=dev), _meta(1, 16, 4, device=dev), chunk=8),
}
FUNCTIONS = {"rmsnorm": "RMSNormFunctionBackward",
             "flash_attention": "FlashAttentionFunctionBackward"}


@pytest.mark.parametrize("name", sorted(KERNEL_CALLS))
def test_no_kernel_drops_a_gradient_silently(name):
    """Under autograd ``rmsnorm`` and ``flash_attention`` go to their
    ``autograd.Function`` (whose forward is the kernel; on ``meta`` tensors, the
    dry-run's, its route that returns empty outputs; on the CPU its plain version),
    and the three kernels without a backward raise ``NotImplementedError`` naming
    themselves on a CUDA tensor (a fake one: the tests run without a card) and take
    their plain version on ``meta`` tensors: every output carries a gradient, the
    same on the CPU as on ``meta``. Without grad each goes to its kernel, which on
    ``meta`` tensors launches nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    call = KERNEL_CALLS[name]
    out, on_cpu = (o[0] if isinstance(o, tuple) else o for o in (call("meta"), call("cpu")))
    assert out.requires_grad and out.grad_fn is not None
    assert type(on_cpu.grad_fn).__name__ == type(out.grad_fn).__name__
    if name in FUNCTIONS:
        assert type(out.grad_fn).__name__ == FUNCTIONS[name]
    else:
        assert type(out.grad_fn).__name__ not in FUNCTIONS.values()
        with FakeTensorMode(), pytest.raises(NotImplementedError,
                                             match=f"^{name}: the CUDA kernel has no backward"):
            call("cuda")
    ops.reset_launch_counts()
    with torch.no_grad():
        out = call("meta")
    out = out[0] if isinstance(out, tuple) else out
    assert out.device.type == "meta" and out.grad_fn is None
    assert ops.launch_counts()[name] == 0
