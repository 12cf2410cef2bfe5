"""The port's MoE layer against the JAX package's, on the same inputs.

Weights come from ``repro``'s ``init_params`` (float32) and are carried
across by ``repro_torch.bridge``; activations come from a numpy seed.
Everything runs on the CPU, where ``ops.moe_gmm`` takes its plain version.
Tolerance: 2e-3 (float32, ``tests/test_kernels.py::_tol``), for sums taken
in another order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import ModelConfig as JaxConfig  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models.common import init_params as jax_init_params  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import ModelConfig  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import moe  # noqa: E402

TOL = dict(rtol=2e-3, atol=2e-3)
# tests/test_ssm_moe.py:62-112: high capacity (no drops) and capacity ~0 (most dropped)
CAPACITY = {"high": 8.0, "dropping": 1e-6}


def _cfgs(e=8, k=2, d=16, f=32, factor=8.0, shared=0):
    kw = dict(name="t", family="moe", num_layers=1, d_model=d, num_heads=2, num_kv_heads=2,
              d_ff=f, vocab_size=64, num_experts=e, experts_per_token=k,
              moe_capacity_factor=factor, shared_expert_d_ff=shared)
    return JaxConfig(**kw), ModelConfig(**kw)


def _params(jcfg, seed=0):
    jp = jax_init_params(jax_moe.param_template(jcfg), jax.random.PRNGKey(seed), "float32")
    return jp, bridge.from_numpy_tree(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _x(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _zero_rows(y):
    return np.all(np.abs(np.asarray(y).reshape(-1, y.shape[-1])) < 1e-9, axis=-1)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen3-moe-235b-a22b"])
@pytest.mark.parametrize("size", ["full", "smoke"])
def test_expert_capacity_matches_jax(arch, size):
    mine, ref = ((get_config(arch), jax_get_config(arch)) if size == "full"
                 else (get_smoke(arch), jax_get_smoke(arch)))
    for factor in (1e-6, 0.5, 1.25, 8.0):
        for tokens in (1, 2, 4, 7, 8, 16, 24, 100, 136, 160, 1000, 1024):
            got = moe.expert_capacity(mine.replace(moe_capacity_factor=factor), tokens)
            want = jax_moe.expert_capacity(ref.replace(moe_capacity_factor=factor), tokens)
            assert got == want, (factor, tokens)
    if arch == "olmoe-1b-7b" and size == "full":
        # the serving path's capacities: a 1024-token prefill, a 4-slot decode step
        assert moe.expert_capacity(mine, 1024) == 160 and moe.expert_capacity(mine, 4) == 8


@pytest.mark.parametrize("e,k,tokens", [(8, 2, 32), (64, 8, 40), (4, 1, 9)])
def test_route_matches_jax(e, k, tokens):
    jcfg, _ = _cfgs(e=e, k=k)
    jp, tp = _params(jcfg, seed=e + k)
    xj, xt = _x((tokens, jcfg.d_model), seed=tokens)
    ji, jw, ja = jax_moe._route(xj, jp["router"], k)
    ti, tw, ta = moe._route(xt, tp["router"], k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)
    # a leading group dim routes each group on its own
    gi, gw, ga = moe._route(xt.reshape(1, tokens, -1).expand(2, -1, -1), tp["router"], k)
    assert torch.equal(gi[1], ti) and torch.equal(gw[0], tw) and torch.allclose(ga, ta)


@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
@pytest.mark.parametrize("capacity", ["high", "dropping"])
@pytest.mark.parametrize("shape,group", [((2, 16), 32), ((4, 32), 32), ((1, 128), 128)])
def test_apply_moe_matches_jax(dispatch, capacity, shape, group):
    """Both of the port's dispatches give the reference's einsum dispatch,
    the same rows dropped; with no drops, the reference's sort dispatch too."""
    jcfg, cfg = _cfgs(factor=CAPACITY[capacity])
    jp, tp = _params(jcfg)
    xj, xt = _x(shape + (jcfg.d_model,), seed=5)
    want, want_aux = jax_moe.apply_moe(xj, jp, jcfg, dispatch="einsum", group_size=group)
    got, aux = moe.apply_moe(xt, tp, cfg, dispatch=dispatch, group_size=group)
    assert got.shape == xt.shape and got.dtype == xt.dtype
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    np.testing.assert_array_equal(_zero_rows(got.numpy()), _zero_rows(want))
    if capacity == "dropping":  # some assignments were dropped
        no_drops, _ = jax_moe.apply_moe(xj, jp, jcfg.replace(moe_capacity_factor=8.0),
                                        group_size=group)
        assert not np.allclose(np.asarray(want), np.asarray(no_drops), **TOL)
        assert group < 128 or _zero_rows(want).mean() > 0.5
    else:
        want_sort, _ = jax_moe.apply_moe(xj, jp, jcfg, dispatch=dispatch, group_size=group)
        np.testing.assert_allclose(got.numpy(), np.asarray(want_sort), **TOL)


def test_reference_sort_dispatch_also_drops_rank0_of_full_experts():
    """The reference's sort dispatch writes the zeros of dropped assignments to
    slot (expert, 0), and the last write wins: the rank-0 assignment of every
    expert that overflows is lost too. Its rows differ from the einsum
    dispatch's (and the port's) exactly at the tokens that lost one."""
    jcfg, cfg = _cfgs(factor=CAPACITY["dropping"])
    jp, tp = _params(jcfg)
    xj, xt = _x((1, 128, jcfg.d_model), seed=5)
    ref_sort, _ = jax_moe.apply_moe(xj, jp, jcfg, dispatch="sort", group_size=128)
    port, _ = moe.apply_moe(xt, tp, cfg, dispatch="sort", group_size=128)

    idx = moe._route(xt[0], tp["router"], cfg.experts_per_token)[0].reshape(-1).numpy()
    cap = moe.expert_capacity(cfg, 128)
    full = [ex for ex in range(cfg.num_experts) if (idx == ex).sum() > cap]
    lost = {int(np.flatnonzero(idx == ex)[0]) // cfg.experts_per_token for ex in full}
    assert lost
    differs = np.any(np.abs(np.asarray(ref_sort[0]) - port[0].numpy()) > 1e-6, axis=-1)
    assert set(np.flatnonzero(differs).tolist()) == lost


def test_shared_expert_matches_jax():
    jcfg, cfg = _cfgs(shared=24, factor=1.25)
    jp, tp = _params(jcfg)
    xj, xt = _x((2, 8, jcfg.d_model), seed=9)
    want, _ = jax_moe.apply_moe(xj, jp, jcfg, group_size=16)
    got, _ = moe.apply_moe(xt, tp, cfg, group_size=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_group_size_must_divide_the_tokens():
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg)
    xj, xt = _x((1, 12, jcfg.d_model), seed=1)
    with pytest.raises(AssertionError, match="not divisible"):
        jax_moe.apply_moe(xj, jp, jcfg, group_size=8)
    with pytest.raises(ValueError, match="not divisible"):
        moe.apply_moe(xt, tp, cfg, group_size=8)


def test_expert_products_go_through_ops_moe_gmm(monkeypatch):
    """Every expert product is one ``ops.moe_gmm`` call on [E, G*C, D] rows."""
    jcfg, cfg = _cfgs()
    _, tp = _params(jcfg)
    calls = []
    real = ops.moe_gmm

    def spy(xe, we, live=None):
        calls.append((tuple(xe.shape), tuple(we.shape)))
        return real(xe, we, live)

    monkeypatch.setattr(ops, "moe_gmm", spy)
    cap = moe.expert_capacity(cfg, 8)
    for dispatch in ("einsum", "sort"):
        calls.clear()
        moe.apply_moe(_x((2, 16, cfg.d_model), seed=2)[1], tp, cfg, dispatch=dispatch, group_size=8)
        e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
        assert calls == [((e, 4 * cap, d), (e, d, f))] * 2 + [((e, 4 * cap, f), (e, f, d))]
