"""``serve_lm`` as a composition on each package's worker node and SDK.

granite-8b smoke in float32, the JAX tree carried across by
``repro_torch.bridge``: the port's ``serve_on_node`` (one ``generate``
vertex over its ``ContinuousBatcher``, run for real by a
``repro_torch.core.WorkerNode``) against the same composition on
``repro.core.WorkerNode`` over the JAX batcher, as
``examples/serve_lm.py`` builds it, and against the port's batcher run
directly with the calls the payload makes. The port's ``serve_on_platform``
(the composition declared through ``repro_torch.sdk``) on a one-node and an
elastic ``sdk.Platform`` against ``examples/serve_lm.py``'s composition on
``repro.sdk.Platform`` over the JAX batcher.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import core as ref_core  # noqa: E402
from repro import sdk as ref_sdk  # noqa: E402
from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.models.model import build as jax_build  # noqa: E402
from repro.serving.batching import ContinuousBatcher as JaxBatcher  # noqa: E402
from repro.serving.batching import Request as JaxRequest  # noqa: E402
from repro_torch import bridge, sdk  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.serving.batching import ContinuousBatcher, Request  # noqa: E402
from repro_torch.serving.serve_lm import (  # noqa: E402
    serve_lm_app,
    serve_lm_sdk_app,
    serve_on_node,
    serve_on_platform,
    tokens_of,
)

ARCH, SLOTS, CACHE_LEN, MAX_NEW = "granite-8b", 4, 32, 6


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_smoke(ARCH).replace(dtype="float32")
    japi = jax_build(jcfg)
    jparams = japi.init_params(jax.random.PRNGKey(0))
    api = build(get_smoke(ARCH).replace(dtype="float32"), device="cpu")
    params = bridge.from_numpy_tree(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, size=int(n)).tolist()
               for n in rng.integers(3, 12, size=4)]
    return japi, jparams, api, params, prompts


def _reference_node(japi, jparams, prompts):
    """examples/serve_lm.py:54-87 on repro.core (the SDK's single-node
    Platform is a WorkerNode with these slots)."""
    batcher = JaxBatcher(japi, jparams, num_slots=SLOTS, cache_len=CACHE_LEN)
    rid_counter = [0]

    def generate_fn(inputs):
        prompt = list(np.frombuffer(inputs["prompt"][0].data, np.int32))
        rid_counter[0] += 1
        rid = rid_counter[0]
        batcher.submit(JaxRequest(rid, prompt, max_new_tokens=MAX_NEW))
        out = batcher.run_to_completion()[rid]
        return {"tokens": [ref_core.Item(np.asarray(out, np.int32).tobytes())]}

    reg = ref_core.FunctionRegistry()
    reg.register_function("generate", generate_fn, context_bytes=8 << 20, memoize=False,
                          pure_unsafe=True)
    app = ref_core.Composition("serve_lm")
    g = app.compute("generate", "generate", inputs=("prompt",), outputs=("tokens",),
                    context_bytes=8 << 20)
    app.bind_input("prompt", g["prompt"])
    app.bind_output("tokens", g["tokens"])
    reg.register_composition(app)
    node = ref_core.WorkerNode(reg, num_slots=4, comm_slots=1)
    runs = [None] * len(prompts)
    for i, p in enumerate(prompts):
        node.invoke_at(i * 1e-3, app, {"prompt": [ref_core.Item(np.asarray(p, np.int32).tobytes())]},
                       on_done=lambda inv, i=i: runs.__setitem__(i, inv))
    node.run()
    return node, runs


def test_serve_lm_tokens_equal_across_packages(models):
    japi, jparams, api, params, prompts = models
    ref_node, ref_runs = _reference_node(japi, jparams, prompts)
    batcher = ContinuousBatcher(api, params, num_slots=SLOTS, cache_len=CACHE_LEN)
    node, runs = serve_on_node(batcher, prompts, MAX_NEW)
    assert all(r is not None and not r.failed for r in runs + ref_runs)
    want = [np.frombuffer(r.outputs["tokens"][0].data, np.int32).tolist() for r in ref_runs]
    got = [tokens_of(r) for r in runs]
    assert got == want
    assert all(len(t) == MAX_NEW for t in got)
    assert node.failed_count == ref_node.failed_count == 0
    assert node.latency.summary()["n"] == len(prompts)
    # every request ran alone, to completion: MAX_NEW - 1 decode steps each
    assert batcher.steps == len(prompts) * (MAX_NEW - 1)
    assert node.tracker.committed == 0


def test_serve_lm_equals_the_batcher_run_directly(models):
    """The node's tokens are those of the payload's call sequence: each
    request submitted and run to completion on one batcher, in order."""
    _, _, api, params, prompts = models
    node, runs = serve_on_node(ContinuousBatcher(api, params, num_slots=SLOTS,
                                                 cache_len=CACHE_LEN), prompts, MAX_NEW)
    direct = ContinuousBatcher(api, params, num_slots=SLOTS, cache_len=CACHE_LEN)
    want = []
    for rid, p in enumerate(prompts, start=1):
        direct.submit(Request(rid, p, max_new_tokens=MAX_NEW))
        want.append(direct.run_to_completion()[rid])
    assert [tokens_of(r) for r in runs] == want
    # billed from the measured executions: each latency covers its run
    assert all(r.latency > 0 for r in runs)


def test_serve_lm_app_registers_one_real_execution_vertex(models):
    _, _, api, params, _ = models
    reg, app = serve_lm_app(ContinuousBatcher(api, params, num_slots=1, cache_len=CACHE_LEN), 2)
    cf = reg.get("generate")
    assert (cf.memoize, cf.pure_unsafe, cf.service_time_s) == (False, True, None)
    assert list(app.vertices) == ["generate"] and reg.get_composition("serve_lm") is app


def _platform(P, shape):
    """examples/serve_lm.py's platform, or quickstart.py's elastic one."""
    if shape == "node":
        return P.Platform(node=P.NodeSpec(num_slots=4, comm_slots=1))
    return P.Platform(elastic=P.Elastic(config=P.ControlPlaneConfig(min_nodes=1, max_nodes=2),
                                        node=P.NodeSpec(num_slots=4)))


def _reference_platform(japi, jparams, prompts, shape):
    """examples/serve_lm.py:50-87 on repro.sdk over the JAX batcher."""
    batcher = JaxBatcher(japi, jparams, num_slots=SLOTS, cache_len=CACHE_LEN)
    rid_counter = [0]

    def generate_fn(inputs):
        prompt = list(np.frombuffer(inputs["prompt"][0].data, np.int32))
        rid_counter[0] += 1
        rid = rid_counter[0]
        batcher.submit(JaxRequest(rid, prompt, max_new_tokens=MAX_NEW))
        out = batcher.run_to_completion()[rid]
        return {"tokens": [ref_core.Item(np.asarray(out, np.int32).tobytes())]}

    generate = ref_sdk.declare("generate", generate_fn, inputs=("prompt",), outputs=("tokens",),
                               context_bytes=8 << 20, memoize=False, pure_unsafe=True)
    with ref_sdk.composition("serve_lm") as app:
        g = generate(prompt=app.input("prompt"))
        app.output("tokens", g.tokens)
    platform = _platform(ref_sdk, shape)
    platform.deploy(app)
    handles = [platform.invoke(app, {"prompt": [ref_core.Item(np.asarray(p, np.int32).tobytes())]},
                               at=i * 1e-3) for i, p in enumerate(prompts)]
    platform.run()
    return platform, handles


@pytest.mark.parametrize("shape", ("node", "elastic"))
def test_serve_on_platform_tokens_equal_across_packages(models, shape):
    japi, jparams, api, params, prompts = models
    _, ref_handles = _reference_platform(japi, jparams, prompts, shape)
    batcher = ContinuousBatcher(api, params, num_slots=SLOTS, cache_len=CACHE_LEN)
    platform = _platform(sdk, shape)
    handles = serve_on_platform(batcher, prompts, MAX_NEW, platform)
    assert all(h.done for h in handles + ref_handles)
    want = [np.frombuffer(h.outputs["tokens"][0].data, np.int32).tolist() for h in ref_handles]
    got = [tokens_of(h) for h in handles]
    assert got == want and all(len(t) == MAX_NEW for t in got)
    assert platform.latency.summary()["n"] == len(prompts)
    assert all(h.latency > 0 for h in handles)
    if shape == "elastic":
        assert platform.control_plane is not None and platform.nodes[0].name == "en0"


def test_one_app_serves_on_two_platforms(models):
    """The same app object goes to a node and then to an elastic cluster; its
    request counter runs on, its tokens stay those of the batcher."""
    _, _, api, params, prompts = models
    batcher = ContinuousBatcher(api, params, num_slots=SLOTS, cache_len=CACHE_LEN)
    app = serve_lm_sdk_app(batcher, MAX_NEW)
    first = serve_on_platform(batcher, prompts, MAX_NEW, _platform(sdk, "node"), app=app)
    second = serve_on_platform(batcher, prompts, MAX_NEW, _platform(sdk, "elastic"), app=app)
    assert [tokens_of(h) for h in second] == [tokens_of(h) for h in first]
    assert batcher.steps == 2 * len(prompts) * (MAX_NEW - 1)


def test_main_serves_the_smoke_config_on_the_cpu(capsys):
    from repro_torch.serving.serve_lm import main

    main(["--arch", "olmoe-1b-7b", "--device", "cpu", "--requests", "3", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "arch=olmoe-1b-7b-smoke" in out and "on cpu" in out
    assert "served 3/3 requests, 12 tokens" in out
