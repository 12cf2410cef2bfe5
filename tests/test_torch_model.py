"""The port's model against the JAX package's, on the smoke configs of the
decoder-only families: granite-8b, glm4-9b (G = 4 at smoke size, 16 at full
width), qwen2.5-32b (QKV bias, drawn non-zero here) and deepseek-67b (dense),
olmoe-1b-7b (MoE, MHA), qwen3-moe-235b-a22b (MoE with GQA), mamba2-130m (SSM)
and hymba-1.5b (parallel attention and SSM heads, sliding-window and global
layers); every registered config against the reference's; and the hybrid
prefill's sliding cache, where the port keeps each prompt's trailing window
and the reference does not. The vlm and encdec families have their own files.

Weights come from ``repro``'s ``init_params`` and are carried across by
``repro_torch.bridge``; token inputs come from a numpy seed. Everything runs
on the CPU, where the port's kernels take their plain versions.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro.models.model import build as jax_build  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro.configs import ARCH_IDS as JAX_ARCHS  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_smoke  # noqa: E402
from repro_torch.models.common import tree_items  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.model import build  # noqa: E402

ARCH = "granite-8b"
ARCHS = ["granite-8b", "glm4-9b", "qwen2.5-32b", "deepseek-67b", "olmoe-1b-7b",
         "qwen3-moe-235b-a22b", "mamba2-130m", "hymba-1.5b"]
TOL = {"float32": dict(rtol=2e-3, atol=2e-3),
       "bfloat16": dict(rtol=5e-2, atol=5e-1)}   # tests/test_serving.py:48


def with_qkv_bias(jparams, cfg, seed=5):
    """The JAX tree with non-zero ``bq``/``bk``/``bv`` (N(0, 0.5) from a numpy seed)
    where the config has a QKV bias: the template's zeros would hide the bias path."""
    if not cfg.qkv_bias:
        return jparams
    rng = np.random.default_rng(seed)
    attn = dict(jparams["blocks"]["attn"])
    for name in ("bq", "bk", "bv"):
        attn[name] = jnp.asarray(0.5 * rng.standard_normal(attn[name].shape), attn[name].dtype)
    return {**jparams, "blocks": {**jparams["blocks"], "attn": attn}}


def _models(dtype, arch=ARCH):
    jcfg = jax_get_smoke(arch).replace(dtype=dtype)
    japi = jax_build(jcfg)
    jparams = with_qkv_bias(japi.init_params(jax.random.PRNGKey(0)), jcfg)
    api = build(get_smoke(arch).replace(dtype=dtype), device="cpu")
    params = bridge.from_numpy_tree(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return japi, jparams, api, params


def _jax_paths(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(p.key) for p in path): leaf for path, leaf in flat}


def _assert_cache_equal(tcache, jcache, tol):
    """Same tree and dtypes; int leaves equal, float leaves within ``tol``."""
    jflat, tflat = _jax_paths(jcache), dict(tree_items(tcache))
    assert sorted(jflat) == sorted(tflat)
    for path, t in tflat.items():
        want = np.asarray(jflat[path])
        assert str(t.dtype).removeprefix("torch.") == want.dtype.name, path
        if want.dtype == np.int32:
            np.testing.assert_array_equal(t.numpy(), want, err_msg=path)
        else:
            np.testing.assert_allclose(bridge.to_numpy(t), want.astype(np.float32), err_msg=path,
                                       **tol)


def test_registry_holds_every_reference_arch_in_its_order():
    from repro.configs import ARCH_IDS as JAX_ARCH_IDS

    assert ARCH_IDS == JAX_ARCH_IDS and len(ARCH_IDS) == 10


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_configs_match_the_reference(arch):
    from repro.configs import get_config as jax_get_config

    for mine, ref in ((get_config(arch), jax_get_config(arch)), (get_smoke(arch), jax_get_smoke(arch))):
        for f in ("name", "family", "num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
                  "vocab_size", "head_dim", "qkv_bias", "tie_embeddings", "rope_theta", "norm_eps",
                  "dtype", "num_experts", "experts_per_token", "moe_capacity_factor",
                  "shared_expert_d_ff", "ssm_state", "ssm_expand", "ssm_head_dim",
                  "ssm_conv_dim", "ssm_chunk", "sliding_window", "global_attn_layers",
                  "encoder_layers", "encoder_frames", "num_patches"):
            assert getattr(mine, f) == getattr(ref, f), f
        assert mine.resolved_head_dim == ref.resolved_head_dim
        assert (mine.d_inner, mine.ssm_heads) == (ref.d_inner, ref.ssm_heads)
        assert mine.layer_params() == ref.layer_params()
        assert mine.num_params() == ref.num_params()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridged_params_keep_paths_shapes_and_bits(dtype, arch):
    """Paths, shapes, dtypes (the MoE router and the SSM's A_log, D and dt_bias stay
    float32 in a bf16 tree) and bits."""
    _, jparams, api, params = _models(dtype, arch)
    jflat = _jax_paths(jparams)
    flat = dict(tree_items(params))
    assert sorted(flat) == sorted(jflat)
    assert {p: tuple(s.shape) for p, s in tree_items(api.param_template)} == \
        {p: tuple(a.shape) for p, a in jflat.items()}
    for path, t in flat.items():
        want = np.asarray(jflat[path])
        assert str(t.dtype).removeprefix("torch.") == want.dtype.name, path
        if dtype == "bfloat16":   # the same 16 bits, read through uint16
            np.testing.assert_array_equal(t.view(torch.int16).numpy(), want.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_logits_match_jax(dtype, arch):
    japi, jparams, api, params = _models(dtype, arch)
    rng = np.random.default_rng(3)
    B, S = 2, 16
    tokens = rng.integers(0, api.cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    plens = np.array([S, 11], np.int32)

    jl, jcache = jax.jit(japi.prefill)(jparams, jnp.asarray(tokens[:, :S]), jnp.asarray(plens))
    tl, tcache = api.prefill(params, torch.from_numpy(tokens[:, :S]), torch.from_numpy(plens))
    np.testing.assert_allclose(bridge.to_numpy(tl), np.asarray(jl), **TOL[dtype])

    # the prefill cache: same tree, same values (S <= the hybrid's window: the
    # two sliding caches agree)
    _assert_cache_equal(tcache, jcache, TOL[dtype])

    nxt = tokens[np.arange(B), plens]
    jd, jcache = jax.jit(japi.decode_step)(jparams, jcache, jnp.asarray(nxt))
    td, tcache = api.decode_step(params, tcache, torch.from_numpy(nxt))
    np.testing.assert_allclose(bridge.to_numpy(td), np.asarray(jd), **TOL[dtype])
    np.testing.assert_array_equal(tcache["pos"].numpy(), plens + 1)
    _assert_cache_equal(tcache, jcache, TOL[dtype])


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_aux_loss_matches_jax(arch):
    """The MoE aux loss averaged over layers, as the reference's scan gives it (0 for dense)."""
    jcfg = jax_get_smoke(arch).replace(dtype="float32")
    _, jparams, api, params = _models("float32", arch)
    tokens = np.random.default_rng(6).integers(0, jcfg.vocab_size, size=(2, 16)).astype(np.int32)
    jh, _, jaux = jax.jit(lambda p, t: jax_transformer.forward_hidden(p, t, jcfg))(
        jparams, jnp.asarray(tokens))
    h, caches, aux = transformer.forward_hidden(params, torch.from_numpy(tokens), api.cfg)
    assert caches is None and aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL["float32"])
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=1e-7)
    assert (float(aux) > 0) == (api.cfg.family == "moe")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_decode_consistency(dtype):
    """Counterpart of tests/test_serving.py::test_prefill_decode_consistency:
    prefill(t[0:S]) then decode(t[S]) gives the logits of prefill(t[0:S+1])."""
    _check_prefill_decode_consistency(ARCH, dtype)


@pytest.mark.parametrize("arch", ["mamba2-130m", "hymba-1.5b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_decode_consistency_ssm_hybrid(arch, dtype):
    _check_prefill_decode_consistency(arch, dtype)


@pytest.mark.parametrize("arch", ["glm4-9b", "qwen2.5-32b", "deepseek-67b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_decode_consistency_dense(arch, dtype):
    _check_prefill_decode_consistency(arch, dtype)


def test_qkv_bias_reaches_the_logits():
    """qwen2.5's drawn biases move the port's logits (so the comparisons above
    hold the bias path, not a zero)."""
    _, _, api, params = _models("float32", "qwen2.5-32b")
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, 384, size=(1, 12)).astype(np.int32))
    plens = torch.tensor([12], dtype=torch.int32)
    zero = {**params, "blocks": {**params["blocks"], "attn": {
        k: torch.zeros_like(v) if k in ("bq", "bk", "bv") else v
        for k, v in params["blocks"]["attn"].items()}}}
    assert all(params["blocks"]["attn"][b].abs().max() > 0.1 for b in ("bq", "bk", "bv"))
    with_bias, without = api.prefill(params, tokens, plens)[0], api.prefill(zero, tokens, plens)[0]
    assert (with_bias - without).abs().max() > 1e-2


def _check_prefill_decode_consistency(arch, dtype):
    _, _, api, params = _models(dtype, arch)
    rng = np.random.default_rng(2)
    B, S = 2, 16
    tokens = torch.from_numpy(rng.integers(0, api.cfg.vocab_size, size=(B, S + 1)).astype(np.int32))
    full_logits, _ = api.prefill(params, tokens, torch.full((B,), S + 1, dtype=torch.int32))
    _, cache = api.prefill(params, tokens, torch.full((B,), S, dtype=torch.int32))
    step_logits, _ = api.decode_step(params, cache, tokens[:, S])
    a, b = full_logits.numpy(), step_logits.numpy()
    np.testing.assert_allclose(a, b, rtol=5e-2, atol=5e-1)
    assert (np.argmax(a, -1) == np.argmax(b, -1)).mean() >= 0.5


def _assert_empty_cache_matches_jax(arch, batch, cache_len):
    jcache = jax_transformer.empty_cache(jax_get_smoke(arch), batch, cache_len)
    tcache = build(get_smoke(arch), device="cpu").init_cache(batch, cache_len)
    jflat, tflat = _jax_paths(jcache), dict(tree_items(tcache))
    assert sorted(jflat) == sorted(tflat)
    for path, t in tflat.items():
        want = np.asarray(jflat[path])
        assert tuple(t.shape) == want.shape, path
        assert str(t.dtype).removeprefix("torch.") == want.dtype.name, path
        np.testing.assert_array_equal(bridge.to_numpy(t), want.astype(np.float32)
                                      if want.dtype.name == "bfloat16" else want)


@pytest.mark.parametrize("batch,cache_len", [(1, 8), (4, 24)])
def test_empty_cache_tree_matches_jax(batch, cache_len):
    _assert_empty_cache_matches_jax(ARCH, batch, cache_len)


@pytest.mark.parametrize("arch", ["mamba2-130m", "hymba-1.5b"])
@pytest.mark.parametrize("batch,cache_len", [(1, 8), (4, 24), (2, 64)])
def test_empty_cache_tree_matches_jax_ssm_hybrid(arch, batch, cache_len):
    """The SSM state (h float32, conv_buf bf16) and, for hymba, the global and
    sliding caches, the latter min(window, S) slots long (64 > the smoke window 32)."""
    _assert_empty_cache_matches_jax(arch, batch, cache_len)


def test_init_params_is_seeded_and_scaled():
    api = build(get_smoke(ARCH), device="cpu")
    assert api.param_count() == api.cfg.num_params()
    assert api.param_bytes() == 2 * api.cfg.num_params()  # bf16
    a = api.init_params(torch.Generator().manual_seed(0))
    b = api.init_params(torch.Generator().manual_seed(0))
    c = api.init_params(torch.Generator().manual_seed(1))
    fa, fb, fc = dict(tree_items(a)), dict(tree_items(b)), dict(tree_items(c))
    for path in fa:
        assert torch.equal(fa[path], fb[path]), path
    assert not torch.equal(fa["blocks/attn/wq"], fc["blocks/attn/wq"])
    assert torch.equal(fa["final_norm"], torch.ones_like(fa["final_norm"]))
    embed = fa["embed"].float()
    assert abs(embed.std().item() - 0.02) < 0.002
    # fan-in scaled truncated normal: std(N(0,1) cut at +-2) ~ 0.8796 / sqrt(fan_in)
    wq = fa["blocks/attn/wq"].float()
    fan_in = wq.shape[0] * wq.shape[1]
    assert abs(wq.std().item() * fan_in**0.5 - 0.8796) < 0.05
    assert wq.abs().max().item() <= 2.0 / fan_in**0.5 + 1e-2


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the entry points run there")
    with pytest.raises(RuntimeError, match="cuda"):
        build(get_smoke(ARCH))
    with pytest.raises(RuntimeError, match="cuda"):
        bridge.to_tensor(np.zeros(3, np.float32))


# ------------------------------------------------- the hybrid's sliding cache
FAULT_S, FAULT_W = 64, 32   # hymba smoke: cache 64 > window 32


@pytest.fixture(scope="module")
def hymba32():
    """hymba smoke with float32 weights from PRNGKey(0), both packages, and 65 tokens."""
    japi, jparams, api, params = _models("float32", "hymba-1.5b")
    tokens = np.random.default_rng(1).integers(0, api.cfg.vocab_size, size=(1, FAULT_S + 1))
    return japi, jparams, api, params, tokens.astype(np.int32)


def _padded(tokens, n, s):
    t = np.zeros((1, s), np.int32)
    t[0, :n] = tokens[0, :n]
    return t


def _step_vs_full(prefill, decode, tokens, n, s):
    """max |logits of prefill(t[:n]) + decode_step(t[n]) - logits of prefill(t[:n+1])|,
    and whether the two argmaxes agree; both prefills padded to ``s``."""
    full, _ = prefill(_padded(tokens, n + 1, s), n + 1)
    _, cache = prefill(_padded(tokens, n, s), n)
    step = decode(cache, tokens[:, n])
    a, b = np.asarray(full, np.float32), np.asarray(step, np.float32)
    return float(np.abs(a - b).max()), bool(a.argmax() == b.argmax())


def _port_fns(api, params):
    prefill = lambda t, n: (lambda lc: (bridge.to_numpy(lc[0]), lc[1]))(
        api.prefill(params, torch.from_numpy(t), torch.tensor([n], dtype=torch.int32)))
    decode = lambda c, tok: bridge.to_numpy(api.decode_step(params, c, torch.from_numpy(tok))[0])
    return prefill, decode


def _jax_fns(japi, jparams):
    jp, jd = jax.jit(japi.prefill), jax.jit(japi.decode_step)
    prefill = lambda t, n: jp(jparams, jnp.asarray(t), jnp.asarray([n], jnp.int32))
    decode = lambda c, tok: jd(jparams, c, jnp.asarray(tok))[0]
    return prefill, decode


@pytest.mark.parametrize("plen", [20, 40])
def test_hybrid_sliding_cache_keeps_the_prompts_trailing_window(hymba32, plen):
    """Each sliding layer's ring holds positions max(plen-32, 0)..plen-1, position t
    at slot t % 32, with that position's rotated K and V; the other slots are empty."""
    _, _, api, params, tokens = hymba32
    t = torch.from_numpy(_padded(tokens, plen, FAULT_S))
    plens = torch.tensor([plen], dtype=torch.int32)
    _, cache = api.prefill(params, t, plens)
    _, caches, _ = transformer.forward_hidden(params, t, api.cfg, collect_cache=True,
                                              prompt_lens=plens)
    sliding = [i for i in range(api.cfg.num_layers) if i not in api.cfg.global_attn_layers]
    ring = cache["attn_sliding"]
    assert tuple(ring["slot_pos"].shape) == (len(sliding), 1, FAULT_W)
    for j, layer in enumerate(sliding):
        sp = ring["slot_pos"][j, 0].numpy()
        assert sorted(sp[sp >= 0].tolist()) == list(range(max(plen - FAULT_W, 0), plen))
        for slot in np.nonzero(sp >= 0)[0]:
            assert sp[slot] % FAULT_W == slot
            for leaf in ("k", "v"):
                torch.testing.assert_close(ring[leaf][j, 0, slot], caches[layer][leaf][0, sp[slot]],
                                           rtol=0, atol=0)


@pytest.mark.parametrize("plen", [20, 40])
def test_hybrid_prefill_then_decode_equals_longer_prefill(hymba32, plen):
    """tests/test_serving.py:23's invariant at a cache longer than the window, with
    prompts that do not fill it: the port keeps it within float32 2e-3."""
    _, _, api, params, tokens = hymba32
    err, same_top1 = _step_vs_full(*_port_fns(api, params), tokens, plen, FAULT_S)
    assert err < 2e-3 and same_top1


@pytest.mark.parametrize("plen,ref_err", [(20, 0.48192), (40, 0.16310)])
def test_reference_hybrid_prefill_drops_window_positions(hymba32, plen, ref_err):
    """The reference fills a sliding layer from the padded sequence's last 32
    positions (repro/models/transformer.py:466-474), so a prompt shorter than the
    cache loses positions: its prefill + decode step misses the longer prefill by
    far more than 2e-3, and moves the argmax (ROADMAP.md C)."""
    japi, jparams, _, _, tokens = hymba32
    err, same_top1 = _step_vs_full(*_jax_fns(japi, jparams), tokens, plen, FAULT_S)
    assert err > 0.1 and not same_top1
    assert abs(err - ref_err) < 1e-3


@pytest.mark.parametrize("plen,s,same_cache", [(63, FAULT_S, False), (FAULT_S, FAULT_S, True),
                                               (20, FAULT_W, True), (31, FAULT_W, True)])
def test_hybrid_prefill_agrees_with_reference_where_it_is_right(hymba32, plen, s, same_cache):
    """Where the reference keeps the trailing window (the prompt fills the cache, or
    the cache is no longer than the window), both packages build the same cache and
    give the same logits. At plen = S - 1 the caches differ only in the one slot
    that the next query's window excludes, so the logits still agree."""
    japi, jparams, api, params, tokens = hymba32
    (pp, pd), (jp, jd) = _port_fns(api, params), _jax_fns(japi, jparams)
    t = _padded(tokens, plen, s)
    got, tcache = pp(t, plen)
    want, jcache = jp(t, plen)
    np.testing.assert_allclose(got, np.asarray(want), **TOL["float32"])
    if same_cache:
        _assert_cache_equal(tcache, jcache, TOL["float32"])
    np.testing.assert_allclose(pd(tcache, tokens[:, plen]), np.asarray(jd(jcache, tokens[:, plen])),
                               **TOL["float32"])
