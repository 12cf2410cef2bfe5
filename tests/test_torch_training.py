"""The port's training loss and its gradients against the JAX package.

``chunked_softmax_xent`` with and without a mask, and ``train_loss`` with
the gradient of every leaf for the smoke configs of all ten
architectures, against ``jax.value_and_grad`` of the reference's. Weights
come from ``repro``'s ``init_params`` and cross by ``repro_torch.bridge``;
inputs come from numpy seeds. Everything runs on the CPU, where the port's
kernels take their plain versions. ``tests/test_torch_kernel_grads.py``
holds the kernels' gradients, ``tests/test_torch_train_step.py`` the
optimizer, the step, checkpoints and ``train_lm``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS as JAX_ARCHS  # noqa: E402
from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models.model import build as jax_build  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.common import tree_items  # noqa: E402
from repro_torch.models.layers import chunked_softmax_xent  # noqa: E402
from repro_torch.models.model import build  # noqa: E402

DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _tol(dtype):   # tests/test_kernels.py::_tol
    return dict(rtol=3e-2, atol=3e-2) if dtype == "bfloat16" else dict(rtol=2e-3, atol=2e-3)


def _pair(rng, shape, dtype="float32", scale=1.0):
    """One numpy-seeded array as a JAX array and a CPU tensor with the same bits."""
    j = jnp.asarray((scale * rng.standard_normal(shape)).astype(np.float32), DTYPES[dtype])
    return j, bridge.to_tensor(np.asarray(j), "cpu")


def _jax_paths(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): leaf
            for path, leaf in flat}


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
    jcfg = jax_get_smoke(arch).replace(dtype="float32")
    japi = jax_build(jcfg)
    jparams = japi.init_params(jax.random.PRNGKey(0))
    api = build(get_smoke(arch).replace(dtype="float32"), device="cpu")
    params = bridge.from_numpy_tree(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jcfg, japi, jparams, api, params


@pytest.fixture(autouse=True)
def _counters_stay_zero():
    """The CPU path launches nothing."""
    ops.reset_launch_counts()
    yield
    assert set(ops.launch_counts().values()) == {0}


# ------------------------------------------------------------- the loss
@pytest.mark.parametrize("masked", [False, True])
def test_chunked_softmax_xent_matches_reference(masked):
    rng = np.random.default_rng(3)
    hj, ht = _pair(rng, (2, 64, 16))
    wj, wt = _pair(rng, (16, 50), scale=0.3)
    targets = rng.integers(0, 50, (2, 64)).astype(np.int32)
    mask = (rng.random((2, 64)) < 0.6).astype(np.float32) if masked else None

    def jloss(h, w):
        return jax_layers.chunked_softmax_xent(h, w, jnp.asarray(targets),
                                               None if mask is None else jnp.asarray(mask), 16)

    want, (dh_want, dw_want) = jax.value_and_grad(jloss, argnums=(0, 1))(hj, wj)
    ht.requires_grad_(True)
    wt.requires_grad_(True)
    got = chunked_softmax_xent(ht, wt, torch.from_numpy(targets),
                               None if mask is None else torch.from_numpy(mask), 16)
    dh, dw = torch.autograd.grad(got, (ht, wt))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), float(want), **_tol("float32"))
    np.testing.assert_allclose(dh.numpy(), np.asarray(dh_want), **_tol("float32"))
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_want), **_tol("float32"))


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_train_loss_and_grads_match_reference(arch):
    """Every family's ``train_loss`` (the vlm's loss over its text positions, the
    MoE aux loss weighted, whisper's tied ``embed.T``) and every leaf's gradient."""
    jcfg, japi, jparams, api, params = _models(arch)
    batch = _batch(jcfg)
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda p: japi.train_loss(p, {k: jnp.asarray(v) for k, v in batch.items()})))(jparams)
    loss, grads = _loss_and_grads(api, params, batch)
    np.testing.assert_allclose(loss.item(), float(want), **_tol("float32"))
    jflat = _jax_paths(jgrads)
    assert sorted(jflat) == sorted(grads)
    for path, g in grads.items():
        w = np.asarray(jflat[path])
        assert g.shape == w.shape, path
        # relative to the leaf's largest entry: gradients range over decades between leaves
        np.testing.assert_allclose(g.numpy() / np.abs(w).max(), w / np.abs(w).max(),
                                   err_msg=path, **_tol("float32"))
