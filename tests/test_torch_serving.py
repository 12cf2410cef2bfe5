"""The port's continuous batcher against the JAX package's, token for token.

granite-8b, glm4-9b, qwen2.5-32b (with non-zero QKV biases) and deepseek-67b
(dense), olmoe-1b-7b (MoE), mamba2-130m (SSM) and hymba-1.5b (hybrid) smoke
with float32 weights from ``repro``'s ``init_params``, carried across by
``repro_torch.bridge``. The vlm and encdec batchers are held in
``test_torch_vlm.py`` and ``test_torch_encdec.py``. The decode cache's K/V are bf16 in
both packages, so both round where the reference rounds; the SSM conv
buffer starts bf16 and turns float32 at the first decode step in both.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.models.model import build as jax_build  # noqa: E402
from repro.serving.batching import ContinuousBatcher as JaxBatcher  # noqa: E402
from repro.serving.batching import Request as JaxRequest  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models.common import tree_items  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.serving.batching import ContinuousBatcher, Request  # noqa: E402
from repro_torch.serving.engine import build_serve_steps, generate  # noqa: E402
from test_torch_model import with_qkv_bias  # noqa: E402

CACHE_LEN, MAX_NEW = 24, 6
# tests/test_serving.py:57-73, plus one request that runs past the cache
# (its 20 prompt tokens + 10 new ones overwrite the last slot, as the
# reference's min(pos, S - 1) does; hymba's sliding ring, min(32, 24) = 24
# slots, wraps)
REQUESTS = [([5, 9, 2, 7], MAX_NEW), ([1, 2, 3], MAX_NEW), ([11, 4, 8, 15, 16], MAX_NEW),
            (list(range(3, 23)), 10)]


FAMILY_ARCHS = ["granite-8b", "olmoe-1b-7b", "mamba2-130m", "hymba-1.5b"]


@pytest.fixture(scope="module", params=["granite-8b", "glm4-9b", "qwen2.5-32b", "deepseek-67b",
                                        "olmoe-1b-7b", "mamba2-130m", "hymba-1.5b"])
def models(request):
    jcfg = jax_get_smoke(request.param).replace(dtype="float32")
    japi = jax_build(jcfg)
    jparams = with_qkv_bias(japi.init_params(jax.random.PRNGKey(0)), jcfg)
    api = build(get_smoke(request.param).replace(dtype="float32"), device="cpu")
    params = bridge.from_numpy_tree(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return japi, jparams, api, params


def _run(batcher_cls, request_cls, api, params):
    batcher = batcher_cls(api, params, num_slots=2, cache_len=CACHE_LEN)
    for rid, (prompt, max_new) in enumerate(REQUESTS):
        batcher.submit(request_cls(rid, prompt, max_new_tokens=max_new))
    return batcher.run_to_completion(), batcher


def test_batcher_token_streams_equal_jax(models):
    japi, jparams, api, params = models
    want, jbatcher = _run(JaxBatcher, JaxRequest, japi, jparams)
    got, batcher = _run(ContinuousBatcher, Request, api, params)
    assert got == want
    assert all(len(got[rid]) == n for rid, (_, n) in enumerate(REQUESTS))
    assert batcher.steps == jbatcher._steps
    # the final shared cache: every slot decoded each step (pos advanced for
    # empty ones too), the last request's tail written at min(pos, S - 1) or
    # around the ring; the same tree, dtypes and int leaves
    jflat = {"/".join(str(p.key) for p in path): leaf
             for path, leaf in jax.tree_util.tree_flatten_with_path(jbatcher.cache)[0]}
    flat = dict(tree_items(batcher.cache))
    assert sorted(flat) == sorted(jflat)
    for path, t in flat.items():
        want = np.asarray(jflat[path])
        assert str(t.dtype).removeprefix("torch.") == want.dtype.name, path
        if want.dtype == np.int32:
            np.testing.assert_array_equal(t.numpy(), want, err_msg=path)
        else:   # bf16 cache: tests/test_kernels.py::_tol
            np.testing.assert_allclose(bridge.to_numpy(t), want.astype(np.float32), rtol=3e-2,
                                       atol=3e-2, err_msg=path)


def _generate_and_batcher(api, params):
    """{rid: (generate's tokens, the batcher's tokens)} for the first three requests."""
    got, _ = _run(ContinuousBatcher, Request, api, params)
    out = {}
    for rid, (prompt, max_new) in enumerate(REQUESTS[:3]):
        toks = torch.tensor([prompt + [0] * (CACHE_LEN - len(prompt))], dtype=torch.int32)
        seq = generate(api, params, toks, torch.tensor([len(prompt)], dtype=torch.int32), max_new)
        out[rid] = (seq[0].tolist(), got[rid])
    return out


# generate decodes on the prefill's own float32 cache, the batcher on the bf16
# batched cache, as in the reference: the two agree only where rounding K/V
# moves no argmax. On deepseek-67b smoke they do not (see the test after this).
@pytest.mark.parametrize("models", ["granite-8b", "glm4-9b", "qwen2.5-32b", "olmoe-1b-7b",
                                    "mamba2-130m", "hymba-1.5b"], indirect=True)
def test_generate_equals_batcher(models):
    _, _, api, params = models
    for rid, (seq, got) in _generate_and_batcher(api, params).items():
        assert seq == got, f"req {rid}"


@pytest.mark.parametrize("models", ["deepseek-67b"], indirect=True)
def test_generate_and_batcher_differ_on_deepseek_as_in_the_reference(models):
    """On deepseek-67b smoke the bf16 cache swaps request 1's tokens 5 and 6, in the
    reference as in the port: the two runs differ there and nowhere else."""
    from repro.serving.engine import generate as jax_generate

    japi, jparams, api, params = models
    pairs = _generate_and_batcher(api, params)
    jgot, _ = _run(JaxBatcher, JaxRequest, japi, jparams)
    prompt, max_new = REQUESTS[1]
    toks = np.asarray([prompt + [0] * (CACHE_LEN - len(prompt))], np.int32)
    jseq = np.asarray(jax_generate(japi, jparams, jnp.asarray(toks),
                                   jnp.asarray([len(prompt)], jnp.int32), max_new))[0].tolist()
    seq, got = pairs[1]
    assert (seq, got) == (jseq, jgot[1])
    assert [i for i, (a, b) in enumerate(zip(seq, got)) if a != b] == [4, 5]
    assert (seq[4], seq[5]) == (got[5], got[4])
    assert pairs[0][0] == pairs[0][1] and pairs[2][0] == pairs[2][1]


def test_generate_equals_jax_generate(models):
    from repro.serving.engine import generate as jax_generate

    japi, jparams, api, params = models
    prompt = [11, 4, 8, 15, 16]
    toks = np.asarray([prompt + [0] * (CACHE_LEN - len(prompt))], np.int32)
    plen = np.asarray([len(prompt)], np.int32)
    want = np.asarray(jax_generate(japi, jparams, jnp.asarray(toks), jnp.asarray(plen), MAX_NEW))
    got = generate(api, params, torch.from_numpy(toks), torch.from_numpy(plen), MAX_NEW)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("models", FAMILY_ARCHS, indirect=True)
def test_sampling_takes_an_explicit_generator(models):
    _, _, api, params = models
    toks = torch.tensor([[5, 9, 2, 7] + [0] * (CACHE_LEN - 4)], dtype=torch.int32)
    plen = torch.tensor([4], dtype=torch.int32)
    runs = [generate(api, params, toks, plen, 4, temperature=1.0,
                     generator=torch.Generator().manual_seed(7)) for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert runs[0].shape == (1, 4) and runs[0].dtype == torch.int32
    steps = build_serve_steps(api)
    logits = torch.tensor([[0.0, 5.0, 1.0]])
    assert steps.sample(logits, None, 0.0).tolist() == [1]
    step_logits, nxt, _ = steps.decode(params, steps.prefill(params, toks, plen)[1], runs[0][:, 0])
    assert nxt.tolist() == [int(step_logits[0].argmax())]
