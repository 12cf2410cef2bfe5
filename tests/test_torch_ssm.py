"""The port's Mamba2 mixer (``repro_torch.models.ssm``) against ``repro.models.ssm``.

On mamba2-130m and hymba-1.5b smoke, with weights from ``repro``'s
``init_params`` carried across by ``repro_torch.bridge`` and activations
from a numpy seed: the causal conv, the full-sequence body (S not a chunk
multiple, per-row prompt lengths, the trailing conv windows) and the
one-token decode body; and the port of
``tests/test_ssm_moe.py::test_ssm_prefill_state_equals_decode_steps``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.models.common import init_params as jax_init_params  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.common import init_params, tree_items  # noqa: E402

ARCHS = ["mamba2-130m", "hymba-1.5b"]
DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TOL = {"float32": dict(rtol=2e-3, atol=2e-3),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}   # bf16 rounding of each cast


def _mixer(arch, dtype):
    """(port cfg, JAX cfg, port params, JAX params) of one layer's mixer."""
    jcfg = jax_get_smoke(arch)
    jp = jax_init_params(jax_ssm.param_template(jcfg), jax.random.PRNGKey(0), dtype)
    p = bridge.from_numpy_tree(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return get_smoke(arch), jcfg, p, jp


def _pair(arr, dtype):
    j = jnp.asarray(arr.astype(np.float32), DTYPES[dtype])
    return j, bridge.to_tensor(np.asarray(j), "cpu")


def _close(got, want, dtype):
    np.testing.assert_allclose(bridge.to_numpy(got), np.asarray(want, np.float32), **TOL[dtype])


def test_param_template_matches_jax():
    for arch in ARCHS:
        jt = jax_ssm.param_template(jax_get_smoke(arch))
        t = ssm.param_template(get_smoke(arch))
        assert {k: (s.shape, s.init, s.dtype) for k, s in t.items()} == \
            {k: (s.shape, s.init, s.dtype) for k, s in jt.items()}


def test_ssm_a_init_is_log_uniform_and_float32():
    """A_log = log(U[1, 16]) in float32, D ones, dt_bias zeros, in a bf16 model."""
    cfg = get_smoke("mamba2-130m")
    p = init_params(ssm.param_template(cfg.replace(d_model=512)), torch.Generator().manual_seed(0),
                    "cpu", "bfloat16")
    for name in ("A_log", "D", "dt_bias"):
        assert p[name].dtype == torch.float32, name
    assert p["in_proj"].dtype == torch.bfloat16
    a = p["A_log"]
    assert a.min() >= 0.0 and a.max() <= np.log(16.0) + 1e-6
    u = torch.exp(a)   # U[1, 16]: mean 8.5, sd 15/sqrt(12) ~ 4.33 over 64 heads
    assert abs(u.mean().item() - 8.5) < 1.5 and u.std().item() > 3.0
    assert torch.equal(p["D"], torch.ones_like(p["D"]))
    assert torch.equal(p["dt_bias"], torch.zeros_like(p["dt_bias"]))
    again = init_params(ssm.param_template(cfg.replace(d_model=512)),
                        torch.Generator().manual_seed(0), "cpu", "bfloat16")
    assert torch.equal(a, again["A_log"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1, 9])
def test_causal_conv_matches_jax(s, dtype):
    rng = np.random.default_rng(12)
    xj, xt = _pair(rng.standard_normal((2, s, 24)), dtype)
    wj, wt = _pair(rng.standard_normal((4, 24)), dtype)
    bj, bt = _pair(rng.standard_normal((24,)), dtype)
    got = ssm._causal_conv(xt, wt, bt)
    assert got.dtype == xt.dtype
    _close(got, jax_ssm._causal_conv(xj, wj, bj), dtype)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,plens", [
    (21, (21, 9)),     # S not a chunk multiple (chunk 16), one row padded
    (32, (32, 2)),     # two chunks; a prompt shorter than the conv window
    (2, None),         # S < wc - 1: the conv buffer is left-padded with zeros
    (19, None),        # no prompt lengths: the buffer is the sequence's tail
])
def test_apply_ssm_matches_jax(arch, dtype, s, plens):
    cfg, jcfg, p, jp = _mixer(arch, dtype)
    xj, xt = _pair(np.random.default_rng(13).standard_normal((2, s, cfg.d_model)) * 0.5, dtype)
    pl_j = None if plens is None else jnp.asarray(plens, jnp.int32)
    pl_t = None if plens is None else torch.tensor(plens, dtype=torch.int32)
    want, wstate = jax_ssm.apply_ssm(xj, jp, jcfg, pl_j)
    ops.reset_launch_counts()
    got, state = ssm.apply_ssm(xt, p, cfg, pl_t)
    assert ops.launch_counts()["ssd"] == 0          # CPU tensors: the plain version
    assert got.dtype == xt.dtype and state.h.dtype == torch.float32
    assert state.conv_buf.dtype == xt.dtype
    _close(got, want, dtype)
    _close(state.h, wstate.h, dtype)
    _close(state.conv_buf, wstate.conv_buf, dtype)
    if plens is not None:   # the buffer holds each row's last wc-1 raw inputs, zeros before 0
        short = plens[1]
        assert np.all(bridge.to_numpy(state.conv_buf[1, : max(0, cfg.ssm_conv_dim - 1 - short)]) == 0)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_ssm_decode_matches_jax(arch, dtype):
    cfg, jcfg, p, jp = _mixer(arch, dtype)
    rng = np.random.default_rng(14)
    b, conv_ch = 3, cfg.d_inner + 2 * cfg.ssm_state
    xj, xt = _pair(rng.standard_normal((b, cfg.d_model)) * 0.5, dtype)
    hj, ht = _pair(rng.standard_normal((b, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)) * 0.1,
                   "float32")
    cj, ct = _pair(rng.standard_normal((b, cfg.ssm_conv_dim - 1, conv_ch)) * 0.5, "bfloat16")
    want, wstate = jax_ssm.apply_ssm_decode(xj, jax_ssm.SSMState(hj, cj), jp, jcfg)
    got, state = ssm.apply_ssm_decode(xt, ssm.SSMState(ht, ct), p, cfg)
    assert got.dtype == xt.dtype
    # the bf16 buffer promotes with the new input, as jnp.concatenate does
    assert str(state.conv_buf.dtype).removeprefix("torch.") == np.asarray(wstate.conv_buf).dtype.name
    _close(got, want, dtype)
    _close(state.h, wstate.h, dtype)
    _close(state.conv_buf, wstate.conv_buf, dtype)


def test_init_state_matches_jax():
    cfg, jcfg = get_smoke("hymba-1.5b"), jax_get_smoke("hymba-1.5b")
    for layers in (None, 3):
        want = jax_ssm.init_state(jcfg, 2, layers)
        got = ssm.init_state(cfg, 2, layers, device="cpu")
        for w, g in zip(want, got):
            assert tuple(g.shape) == w.shape
            assert str(g.dtype).removeprefix("torch.") == np.asarray(w).dtype.name
            assert not g.any()


def test_ssm_prefill_state_equals_decode_steps():
    """Running prefill then decoding == decoding every token from scratch
    (tests/test_ssm_moe.py:33-60, on the port)."""
    cfg = get_smoke("mamba2-130m")
    p = init_params(ssm.param_template(cfg), torch.Generator().manual_seed(0), "cpu", "float32")
    b, s = 1, 12
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((b, s, cfg.d_model))
                         .astype(np.float32) * 0.3)
    y_full, state_full = ssm.apply_ssm(x, p, cfg)
    state = ssm.SSMState(
        h=torch.zeros((b, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)),
        conv_buf=torch.zeros((b, cfg.ssm_conv_dim - 1, cfg.d_inner + 2 * cfg.ssm_state)))
    ys = []
    for t in range(s):
        y_t, state = ssm.apply_ssm_decode(x[:, t], state, p, cfg)
        ys.append(y_t)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), y_full.numpy(), rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(state.h.numpy(), state_full.h.numpy(), rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(state.conv_buf.numpy(), state_full.conv_buf.numpy(), rtol=1e-5,
                               atol=1e-6)   # the same projections, taken per token
    assert dict(tree_items(p)).keys() == ssm.param_template(cfg).keys()
