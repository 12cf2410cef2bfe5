"""The port's SDK (``repro_torch.sdk``) against the reference's (``repro.sdk``).

The same modeled application, built in each package from the same seed,
runs on ``sdk.Platform`` in its three shapes: one node, a static pool of
two, and an elastic cluster of one to two nodes. The simulator is
deterministic (virtual durations come from seeded numpy draws in a fixed
order), so outputs, per-handle latencies, the latency summary, committed
bytes, node names and counts, and the control plane's node-count
timeline and routing stats must be equal with ``==``.

The SDK's declaration, wiring and misconfiguration errors must raise the
same class with the same message in both packages. ``_safe_eq``, which
decides whether a re-deployed payload is the same, must hold for torch
tensors, and a declaration's ``torch_fn`` / ``example_args`` must reach
the port's cold-start backends.
"""
import importlib
import types

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

PACKAGES = ("repro", "repro_torch")
SHAPES = ("node", "pool", "elastic")


def _pkg(name: str) -> types.SimpleNamespace:
    return types.SimpleNamespace(sdk=importlib.import_module(f"{name}.sdk"),
                                 core=importlib.import_module(f"{name}.core"))


# ------------------------------------------------------------ modeled app
def _modeled_apps(P, seed: int):
    """tests/test_sdk.py's echo app, and a fan-out DAG src -> each(b) -> join,
    each function with a jittered calibrated profile drawn from ``seed``."""
    sdk, Item = P.sdk, P.core.Item
    rng = np.random.default_rng(100 + seed)

    def profile(execute_s):
        return sdk.ColdStartProfile(float(rng.uniform(1e-4, 5e-4)), execute_s,
                                    jitter_sigma=float(rng.uniform(0.05, 0.4)))

    echo = sdk.single_function_app(sdk.declare(
        "echo", lambda ins: {"out": [Item(b"r:" + ins["x"][0].data)]},
        inputs=("x",), outputs=("out",), profile=profile(1e-3)))
    src = sdk.declare(
        "src", lambda ins: {"parts": [Item(ins["x"][0].data + b"%d" % i, key=f"k{i % 2}")
                                      for i in range(4)]},
        inputs=("x",), outputs=("parts",), profile=profile(2e-3))
    work = sdk.declare(
        "work", lambda ins: {"out": [Item(b"w(" + it.data + b")", it.key) for it in ins["p"]]},
        inputs=("p",), outputs=("out",), context_bytes=4 << 20, profile=profile(8e-3))
    join = sdk.declare(
        "join", lambda ins: {"out": [Item(b"|".join(sorted(it.data for it in ins["xs"])))]},
        inputs=("xs",), outputs=("out",), profile=profile(1e-3))
    with sdk.composition("fanout") as fanout:
        s = src(x=fanout.input("x"))
        w = work(p=sdk.each(s.parts))
        j = join(xs=w.out)
        fanout.output("result", j.out)
    return echo, fanout


def _platform(P, shape: str, seed: int):
    sdk = P.sdk
    if shape == "node":
        return sdk.Platform(node=sdk.NodeSpec(num_slots=4, seed=seed))
    if shape == "pool":
        return sdk.Platform(pool=[sdk.NodeSpec(num_slots=4, seed=seed + i) for i in range(2)])
    return sdk.Platform(elastic=sdk.Elastic(
        config=sdk.ControlPlaneConfig(min_nodes=1, max_nodes=2, target_outstanding_per_node=3.0,
                                      max_queue_delay_s=5e-3, keepalive_s=0.2,
                                      tick_interval_s=0.05,
                                      node_boot=sdk.ColdStartProfile(0.05, 0.0, 0.1)),
        node=sdk.NodeSpec(num_slots=4, seed=seed), seed=seed, journal=True))


def _run(name: str, shape: str, seed: int):
    P = _pkg(name)
    Item = P.core.Item
    platform = _platform(P, shape, seed)
    echo, fanout = _modeled_apps(P, seed)
    platform.deploy(echo)
    platform.deploy(fanout)
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.exponential(4e-3, size=60))
    which = rng.integers(0, 2, size=60)
    handles = [platform.invoke((echo, fanout)[int(w)], {"x": [Item(b"%d" % i)]}, at=float(ti))
               for i, (ti, w) in enumerate(zip(t[:30], which[:30]))]
    streamed = []
    platform.submit_stream((float(ti), (echo, fanout)[int(w)], {"x": [Item(b"s%d" % i)]},
                            streamed.append)
                           for i, (ti, w) in enumerate(zip(t[30:], which[30:])))
    platform.run()

    def outs(o):
        return {k: [(it.data, it.key) for it in v] for k, v in sorted(o.items())}

    nodes = platform.nodes
    seen = {
        "handles": [(h.done, h.failed, h.latency, outs(h.outputs)) for h in handles],
        "streamed": [(inv.failed, inv.latency, outs(inv.outputs)) for inv in streamed],
        "latency": platform.latency.summary(),
        "nodes": [n.name for n in nodes],
        "completed": [n.dispatcher.completed_count for n in nodes],
        "committed": [(n.committed_avg_bytes, n.committed_peak_bytes, n.tracker.committed)
                      for n in nodes],
        "now": platform.loop.now,
    }
    cp = platform.control_plane
    if cp is not None:
        seen["timeline"] = list(cp.node_count_timeline.points)
        seen["routing"] = cp.stats.summary()
        seen["cp_summary"] = cp.summary(float(t[-1]))
        seen["journal"] = list(cp.journal)
    return seen


@pytest.mark.parametrize("seed", (0, 1, 2))
@pytest.mark.parametrize("shape", SHAPES)
def test_modeled_app_equal_across_packages(shape, seed):
    ref, port = (_run(name, shape, seed) for name in PACKAGES)
    assert port == ref
    assert all(done and not failed for done, failed, _, _ in port["handles"])
    assert len(port["streamed"]) == 30 and port["latency"]["n"] == 60
    if shape != "node":
        # both nodes serve: the elastic burst boots the second one early
        assert len(port["nodes"]) == 2 and min(port["completed"]) > 0


# ------------------------------------------------------------- error cases
def _cycle(P):
    sdk, Item = P.sdk, P.core.Item
    f = sdk.declare("f", lambda ins: {"out": [Item(1)]}, inputs=("x",), outputs=("out",))
    with sdk.composition("cyc") as app:
        a = f(_name="a")
        b = f(_name="b", x=a.out)
        a.feed(x=b.out)
    app.compile()


def _unfed(P):
    sdk = P.sdk
    f = sdk.declare("f", lambda ins: {}, inputs=("x", "y"), outputs=("out",))
    with sdk.composition("unfed") as app:
        v = f(_name="lonely", x=app.input("x"))
        app.output("out", v.out)
    app.compile()


def _double_fan_in(P):
    sdk, Item = P.sdk, P.core.Item
    f = sdk.declare("f", lambda ins: {"out": [Item(1)]}, inputs=("x",), outputs=("out",))
    g = sdk.declare("g", lambda ins: {"out": [Item(1)]}, inputs=("a", "b"), outputs=("out",))
    with sdk.composition("fan") as app:
        src = f(_name="src", x=app.input("x"))
        g(_name="sink", a=sdk.each(src.out), b=sdk.key(src.out))


def _unknown_function(P):
    sdk = P.sdk
    ghost = sdk.ref("ghost_fn", inputs=("x",), outputs=("out",))
    with sdk.composition("haunted") as app:
        v = ghost(_name="spooky", x=app.input("x"))
        app.output("out", v.out)
    sdk.Platform().deploy(app)


def _wired(P):
    sdk, Item = P.sdk, P.core.Item
    f = sdk.declare("f", lambda ins: {"out": [Item(1)]}, inputs=("x",), outputs=("out",))
    app = sdk.composition("w")
    return sdk, f, app


def _no_output_set(P):
    sdk, f, app = _wired(P)
    with app:
        v = f(_name="v", x=app.input("x"))
        v.nope


def _no_input_set(P):
    sdk, f, app = _wired(P)
    with app:
        v = f(_name="v", x=app.input("x"))
        f(_name="w2", bad=v.out)


def _duplicate_vertex(P):
    sdk, f, app = _wired(P)
    with app:
        v = f(_name="v", x=app.input("x"))
        f(x=v.out, _name="v")


def _no_active_composition(P):
    sdk, f, _ = _wired(P)
    f(x=None)


def _cross_composition_port(P):
    sdk, f, app = _wired(P)
    with app:
        v = f(_name="v", x=app.input("x"))
        app.output("out", v.out)
    with sdk.composition("other"):
        f(_name="v2", x=v.out)


def _input_feeds_twice(P):
    sdk, f, app = _wired(P)
    with app:
        f(_name="a", x=app.input("x"))
        f(_name="b", x=app.input("x"))


def _positional_ports(P):
    sdk, f, app = _wired(P)
    with app:
        f(app.input("x"))


def _empty_name(P):
    P.sdk.declare("", lambda ins: ins, inputs=("x",), outputs=("y",))


def _duplicate_input(P):
    P.sdk.declare("d", lambda ins: ins, inputs=("x", "x"), outputs=("y",))


def _zero_context(P):
    P.sdk.declare("d", lambda ins: ins, inputs=("x",), outputs=("y",), context_bytes=0)


def _string_inputs(P):
    P.sdk.declare("d", lambda ins: ins, inputs="doc", outputs=("y",))


def _string_outputs(P):
    P.sdk.function(inputs=("x",), outputs="out")(lambda ins: ins)


def _retry_twice(P):
    P.sdk.declare("d", lambda ins: ins, inputs=("x",), outputs=("y",),
                  retry=P.sdk.RetryPolicy(max_retries=1), retries=2)


def _shadowed_output(P):
    sdk = P.sdk
    clash = sdk.declare("c", lambda ins: ins, inputs=("x",), outputs=("feed",))
    with sdk.composition("shadow"):
        clash()


def _crossnode_on_one_node(P):
    P.sdk.Platform(node=P.sdk.NodeSpec(), crossnode=True)


def _transfer_on_one_node(P):
    P.sdk.Platform(transfer_profile=P.sdk.TransferProfile())


def _two_shapes(P):
    P.sdk.Platform(node=P.sdk.NodeSpec(), pool=[P.sdk.NodeSpec()])


def _empty_pool(P):
    P.sdk.Platform(pool=[])


def _route_policy_on_one_node(P):
    P.sdk.Platform(route_policy="batch_aware")


def _unknown_route_policy(P):
    P.sdk.Platform(pool=[P.sdk.NodeSpec()], route_policy="random")


def _duplicate_pool_names(P):
    P.sdk.Platform(pool=[P.sdk.NodeSpec(name="a"), P.sdk.NodeSpec(name="a")]).nodes


def _unresolved_ref(P):
    P.sdk.Platform().deploy(P.sdk.ref("typo_name", inputs=("x",), outputs=("y",)))


def _conflicting_payload(P):
    sdk, Item = P.sdk, P.core.Item
    a = sdk.declare("dup_fn", lambda ins: {"out": [Item(1)]}, inputs=("x",), outputs=("out",))
    b = sdk.declare("dup_fn", lambda ins: {"out": [Item(2)]}, inputs=("x",), outputs=("out",))
    platform = sdk.Platform()
    platform.deploy(sdk.single_function_app(a))
    platform.deploy(sdk.single_function_app(a))  # idempotent
    platform.deploy(b)


def _conflicting_captured_value(P):
    sdk, Item = P.sdk, P.core.Item

    def branch(k):
        return sdk.declare("branch_fn", lambda ins, k=k: {"out": [Item(k)]},
                           inputs=("x",), outputs=("out",))

    platform = sdk.Platform()
    platform.deploy(sdk.single_function_app(branch(0)))
    platform.deploy(sdk.single_function_app(branch(0)))  # same definition, same value
    platform.deploy(sdk.single_function_app(branch(1)))


def _deploy_wrong_type(P):
    P.sdk.Platform().deploy("serve_lm")


def _timed_out(P):
    sdk, Item = P.sdk, P.core.Item
    slow = sdk.declare("slowpoke", lambda ins: {"out": [Item(1)]}, inputs=("x",),
                       outputs=("out",), timeout_s=5e-3,
                       profile=sdk.ColdStartProfile(1e-4, 50e-3, 0.0))
    app = sdk.single_function_app(slow)
    platform = sdk.Platform(node=sdk.NodeSpec(num_slots=2, max_retries=0))
    platform.deploy(app)
    platform.invoke(app, {"x": [Item(b"go")]}).result()


def _still_pending(P):
    sdk, Item = P.sdk, P.core.Item
    app = sdk.single_function_app(sdk.declare(
        "echo", lambda ins: {"out": [Item(1)]}, inputs=("x",), outputs=("out",),
        profile=sdk.ColdStartProfile(1e-4, 1e-3, 0.0)))
    platform = sdk.Platform()
    platform.deploy(app)
    platform.invoke(app, {"x": [Item(b"a")]}, at=5e-3).result(until=1e-3)


def _strict_verify(P):
    sdk, Item = P.sdk, P.core.Item
    seen = []
    spec = sdk.declare("leaky", lambda ins: seen.append(1) or {"out": [Item(1)]},
                       inputs=("x",), outputs=("out",))
    sdk.Platform(verify="strict").deploy(sdk.single_function_app(spec))


ERROR_CASES = {f.__name__.lstrip("_"): f for f in (
    _cycle, _unfed, _double_fan_in, _unknown_function, _no_output_set, _no_input_set,
    _duplicate_vertex, _no_active_composition, _cross_composition_port, _input_feeds_twice,
    _positional_ports, _empty_name, _duplicate_input, _zero_context, _string_inputs,
    _string_outputs, _retry_twice, _shadowed_output, _crossnode_on_one_node,
    _transfer_on_one_node, _two_shapes, _empty_pool, _route_policy_on_one_node,
    _unknown_route_policy, _duplicate_pool_names, _unresolved_ref, _conflicting_payload,
    _conflicting_captured_value, _deploy_wrong_type, _timed_out, _still_pending,
    _strict_verify)}


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_errors_equal_across_packages(case):
    raised = []
    for name in PACKAGES:
        P = _pkg(name)
        with pytest.raises(P.sdk.SDKError) as info:
            ERROR_CASES[case](P)
        raised.append((type(info.value).__name__, str(info.value)))
    assert raised[0] == raised[1]


# ------------------------------------------------------ torch in the SDK
def test_safe_eq_on_tensors():
    from repro_torch.sdk.platform import _safe_eq

    a = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    assert _safe_eq(a, a.clone())
    assert not _safe_eq(a, a.clone().add_(1))
    assert not _safe_eq(a, a.reshape(3, 2))        # same values, another shape
    assert not _safe_eq(a[:1], a)                   # would broadcast
    assert not _safe_eq(a, a.double())              # same values, another dtype
    assert not _safe_eq(a, a.numpy())               # a tensor is not an array
    assert not _safe_eq(a, None)
    assert not _safe_eq(torch.zeros(1), torch.zeros(1, device="meta"))  # another device


def test_redeploy_with_a_captured_tensor():
    """Spec factories close over tensors: an equal tensor is the same payload,
    another one a conflict."""
    from repro_torch import sdk
    from repro_torch.core import Item

    def scaled(w):
        return sdk.declare("scale", lambda ins, w=w: {"out": [Item(w * 2)]},
                           inputs=("x",), outputs=("out",))

    platform = sdk.Platform()
    platform.deploy(sdk.single_function_app(scaled(torch.ones(3))))
    platform.deploy(sdk.single_function_app(scaled(torch.ones(3))))
    for other in (torch.ones(4), torch.ones(3, dtype=torch.float64), torch.zeros(3)):
        with pytest.raises(sdk.DeploymentError, match="scale.*different payload"):
            platform.deploy(sdk.single_function_app(scaled(other)))


def test_torch_payload_reaches_the_cold_start_backends():
    """``torch_fn`` / ``example_args`` of a declaration land on the registry's
    ``ComputeFunction``, and the snapshot backend runs them."""
    from repro_torch import sdk
    from repro_torch.core import FunctionRegistry, Item, cold_start

    gen = torch.Generator().manual_seed(5)
    w = torch.randn((8, 8), generator=gen)

    def mlp(x):
        return torch.tanh(x @ w)

    x = torch.randn((4, 8), generator=gen)

    @sdk.function(inputs=("x",), outputs=("out",), torch_fn=mlp,
                  example_args=[torch.zeros_like(x)])
    def layer(ins):
        return {"out": [Item(mlp(torch.as_tensor(ins["x"][0].data)).numpy())]}

    assert layer.torch_fn is mlp and isinstance(layer.example_args, tuple)
    reg = FunctionRegistry()
    cf = layer.register_into(reg)
    assert cf.torch_fn is mlp and cf.example_args == layer.example_args
    ctx, _, run = cold_start(reg, "layer", {"x": [Item(x.numpy())]}, backend="snapshot",
                             device="cpu")
    got = torch.as_tensor(run()["out"][0].data)
    ctx.free()
    torch.testing.assert_close(got, mlp(x), rtol=2e-3, atol=2e-3)


def test_verify_lists_the_serving_payload_as_unsafe():
    from repro_torch import sdk
    from repro_torch.configs import get_smoke
    from repro_torch.models.model import build
    from repro_torch.serving.batching import ContinuousBatcher
    from repro_torch.serving.serve_lm import serve_lm_sdk_app

    api = build(get_smoke("granite-8b").replace(dtype="float32"), device="cpu")
    params = api.init_params(torch.Generator().manual_seed(0))
    app = serve_lm_sdk_app(ContinuousBatcher(api, params, num_slots=1, cache_len=16), 2)
    report = sdk.verify(app)
    assert tuple(report.unsafe) == ("generate",) and not report.blocking
    assert report.waived  # the findings are kept, waived by pure_unsafe
    platform = sdk.Platform(verify="strict")
    platform.deploy(app)
    platform.deploy(app)  # idempotent: the same payload over the same batcher
    assert tuple(platform.last_verify_report.unsafe) == ("generate",)
