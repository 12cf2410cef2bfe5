"""The port's worker node (``repro_torch.core``) against the reference's
(``repro.core``) on modeled workloads.

The simulator is deterministic: virtual durations come from seeded numpy
draws made in a fixed order. So the same workload through either
package's ``WorkerNode`` must give the same outputs, virtual latencies,
committed bytes, failure counts and engine submissions, compared with
``==``. Each workload is built once per package from the same seed.
"""
import importlib
import types

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

PACKAGES = ("repro", "repro_torch")
SEEDS = (0, 1, 2, 3, 4)


def _pkg(name: str) -> types.SimpleNamespace:
    core = importlib.import_module(f"{name}.core")
    dag = importlib.import_module(f"{name}.core.dag")
    items = importlib.import_module(f"{name}.core.items")
    return types.SimpleNamespace(core=core, dag=dag, items=items)


def _observe(node, done, submits):
    """Everything a run shows: per invocation (in completion order) its
    failure, latency and outputs; the node's latency summary, committed
    bytes and counters; and the engine submissions (time, kind, function,
    attempt), which count retries and hedges."""
    runs = [(inv.failed, inv.failure_kind, inv.latency,
             {k: [(it.data, it.key) for it in v] for k, v in sorted(inv.outputs.items())})
            for inv in done]
    retries = sum(1 for s in submits if s[3] > 0)
    return {
        "runs": runs,
        "latency": node.latency.summary(),
        "committed_avg_bytes": node.committed_avg_bytes,
        "committed_peak_bytes": node.committed_peak_bytes,
        "committed_end": node.tracker.committed,
        "failed_count": node.failed_count,
        "completed": node.dispatcher.completed_count,
        "submits": submits,
        "retries": retries,
        "now": node.loop.now,
    }


def _log_submits(node):
    submits = []
    orig = node.engines.submit

    def submit(task):
        submits.append((node.loop.now, task.kind, task.fn_name, task.attempts))
        return orig(task)

    node.engines.submit = submit
    return submits


# ---------------------------------------------------------------- workloads
def _fuzz_registry(P):
    reg = P.core.FunctionRegistry()
    Item = P.core.Item
    reg.register_function("tag_a", lambda ins: {"out": [Item(f"a({it.data})", it.key)
                                                         for it in ins["x"]]})
    reg.register_function("tag_b", lambda ins: {"out": [Item(f"b({it.data})", it.key)
                                                         for it in ins["x"]]})
    reg.register_function("dup", lambda ins: {"out": [Item(f"{it.data}#{i}", f"{it.key}{i}")
                                                       for it in ins["x"] for i in (0, 1)]})
    reg.register_function("count", lambda ins: {"out": [Item(f"n={len(ins['x'])}")]})
    return reg


FUZZ_FNS = ("tag_a", "tag_b", "dup", "count")
MODES = ("all", "each", "key")


def _random_comp(P, seed: int):
    """As tests/test_dispatcher_properties.py:_random_comp builds it."""
    rng = np.random.default_rng(seed)
    c = P.core.Composition(f"fuzz{seed}")
    n = int(rng.integers(2, 6))
    names = []
    for i in range(n):
        fn = FUZZ_FNS[int(rng.integers(0, len(FUZZ_FNS)))]
        v = c.compute(f"v{i}", fn, inputs=("x",), outputs=("out",))
        if i == 0:
            c.bind_input("in0", v["x"])
        else:
            parent = names[int(rng.integers(0, i))]
            mode = MODES[int(rng.integers(0, len(MODES)))]
            c.edge(c.vertices[parent]["out"], v["x"], mode)
        names.append(f"v{i}")
    consumed = {e.src.vertex for e in c.edges}
    for name in names:
        if name not in consumed:
            c.bind_output(f"out_{name}", c.vertices[name]["out"])
    c.validate()
    return c


def _jittered_profiles(P, seed: int, *, cold: bool = False):
    rng = np.random.default_rng(1000 + seed)
    return {fn: P.core.ColdStartProfile(
                setup_s=float(rng.uniform(1e-4, 1e-3)), execute_s=float(rng.uniform(1e-4, 5e-3)),
                jitter_sigma=float(rng.uniform(0.05, 0.5)),
                cold_setup_s=float(rng.uniform(1e-3, 1e-2)) if cold else 0.0)
            for fn in FUZZ_FNS}


def _random_dags(P, seed, *, cache_miss_rate=0.0, code_cache_entries=0):
    reg = _fuzz_registry(P)
    node = P.core.WorkerNode(reg, num_slots=4, seed=seed,
                             profiles=_jittered_profiles(P, seed, cold=cache_miss_rate > 0),
                             cache_miss_rate=cache_miss_rate,
                             code_cache_entries=code_cache_entries)
    submits = _log_submits(node)
    done = []
    rng = np.random.default_rng(seed)
    for i in range(6):
        comp = _random_comp(P, seed * 10 + i)
        inputs = {"in0": [P.core.Item(f"d{j}", key=f"k{j % 3}") for j in range(4)]}
        node.invoke_at(float(rng.uniform(0, 5e-3)), comp, inputs, on_done=done.append)
    node.run()
    return _observe(node, done, submits)


def _work_registry(P):
    reg = P.core.FunctionRegistry()
    reg.register_function("work", lambda ins: {"out": [P.core.Item(1)]})
    return reg


def _single(P, timeout_s=60.0, retry=None):
    c = P.core.Composition("single_work")
    v = c.compute("work", "work", inputs=("x",), outputs=("out",), timeout_s=timeout_s,
                  retry=retry)
    c.bind_input("x", v["x"])
    c.bind_output("out", v["out"])
    return c


def _timeout_retry(P, seed):
    """Heavy-tailed executions against a 2 ms timeout, retried with backoff."""
    profiles = {"work": P.core.ColdStartProfile(1e-5, 1e-3, 2.0)}
    policy = P.dag.RetryPolicy(max_retries=3, base_backoff_s=1e-3, max_backoff_s=4e-3,
                               retry_timeouts=True)
    node = P.core.WorkerNode(_work_registry(P), num_slots=4, profiles=profiles, seed=seed)
    submits = _log_submits(node)
    done = []
    for i in range(20):
        node.invoke_at(i * 2e-4, _single(P, timeout_s=2e-3, retry=policy),
                       {"x": [P.core.Item(0)]}, on_done=done.append)
    node.run()
    return _observe(node, done, submits)


def _chain_registry(P):
    Item = P.core.Item
    reg = P.core.FunctionRegistry()
    reg.register_function("fan", lambda ins: {"out": [Item(j, key=str(j))
                                                      for j in range(int(ins["x"][0].data))]})
    reg.register_function("double", lambda ins: {"out": [Item(i.data * 2, i.key)
                                                         for i in ins["x"]]})
    reg.register_function("sum", lambda ins: {"out": [Item(sum(i.data for i in ins["x"]))]})
    return reg


def _chain(P, timeout_s=60.0):
    c = P.core.Composition("chain")
    f = c.compute("fan", "fan", inputs=("x",), outputs=("out",))
    d = c.compute("double", "double", inputs=("x",), outputs=("out",), timeout_s=timeout_s)
    s = c.compute("sum", "sum", inputs=("x",), outputs=("out",))
    c.edge(f["out"], d["x"], "each")
    c.edge(d["out"], s["x"], "all")
    c.bind_input("x", f["x"])
    c.bind_output("result", s["out"])
    return c


def _hedging(P, seed):
    """A heavy-tailed fan-out vertex, hedged after 2 ms."""
    profiles = {"fan": P.core.ColdStartProfile(1e-5, 1e-4, 0.0),
                "double": P.core.ColdStartProfile(1e-5, 1e-3, 2.0),
                "sum": P.core.ColdStartProfile(1e-5, 1e-4, 0.0)}
    node = P.core.WorkerNode(_chain_registry(P), num_slots=8, profiles=profiles,
                             hedge_after_s=2e-3, seed=seed)
    node.dispatcher.hedge_min_instances = 2
    submits = _log_submits(node)
    done = []
    for i in range(5):
        node.invoke_at(i * 1e-4, _chain(P), {"x": [P.core.Item(6)]}, on_done=done.append)
    node.run()
    return _observe(node, done, submits)


def _node_failure(P, seed):
    """``node.fail()`` while invocations are queued and in flight."""
    rng = np.random.default_rng(seed)
    profiles = {fn: P.core.ColdStartProfile(1e-4, 1e-3, 0.3) for fn in ("fan", "double", "sum")}
    node = P.core.WorkerNode(_chain_registry(P), num_slots=2, profiles=profiles, seed=seed)
    submits = _log_submits(node)
    done = []
    for i in range(6):
        node.invoke_at(i * 1e-4, _chain(P), {"x": [P.core.Item(3)]}, on_done=done.append)
    node.loop.at(float(rng.uniform(1e-3, 3e-3)), node.fail)
    node.run()
    return _observe(node, done, submits)


def _decode_chain(P, seed):
    """A batch engine (``batch_slots``, ``BatchStepModel``, ``WeightStore``)
    serving prefill -> decode x N chains of several requests."""
    Item = P.core.Item
    reg = P.core.FunctionRegistry()
    reg.register_function("prefill", lambda ins: {"tok": [Item(len(ins["prompt"][0].data) % 97)]})
    reg.register_function("decode", lambda ins: {"tok": [Item((ins["tok"][0].data * 31 + 7) % 97)]},
                          batchable=True)
    profiles = {"prefill": P.core.ColdStartProfile(2e-4, 3e-3, 0.1, cold_setup_s=5e-2),
                "decode": P.core.ColdStartProfile(1e-4, 1e-3, 0.1, cold_setup_s=5e-2)}
    model = P.core.BatchStepModel(flops_per_seq=2e9, fixed_bytes=16e9, bytes_per_seq=64e6,
                                  peak_flops=989e12, hbm_bw=3.35e12, overhead_s=1e-3)
    ws = P.core.WeightStore(keepalive_s=5e-3)
    ws.register("lm", 16 << 20, ("prefill", "decode"))
    node = P.core.WorkerNode(reg, num_slots=4, profiles=profiles, batch_slots=1,
                             batch_model=model, max_batch=8, weight_store=ws, seed=seed)
    submits = _log_submits(node)
    done = []
    rng = np.random.default_rng(seed)
    for rid in range(6):
        n_decode = int(rng.integers(2, 6))
        c = P.core.Composition(f"req{rid}")
        prev = c.compute("prefill", "prefill", inputs=("prompt",), outputs=("tok",))
        c.bind_input("prompt", prev["prompt"])
        for k in range(n_decode):
            v = c.compute(f"decode{k}", "decode", inputs=("tok",), outputs=("tok",))
            c.edge(prev["tok"], v["tok"])
            prev = v
        c.bind_output("tok", prev["tok"])
        prompt = bytes(rng.integers(0, 255, size=int(rng.integers(8, 64)), dtype=np.uint8))
        node.invoke_at(float(rng.uniform(0, 2e-2)), c, {"prompt": [Item(prompt)]},
                       on_done=done.append)
    node.run()
    out = _observe(node, done, submits)
    out["weights"] = ws.summary()
    out["resident_bytes"] = ws.resident_bytes
    return out


WORKLOADS = {
    "random_dags": _random_dags,
    "code_cache_miss": lambda P, seed: _random_dags(P, seed, cache_miss_rate=0.3,
                                                    code_cache_entries=2),
    "timeout_retry_backoff": _timeout_retry,
    "hedging": _hedging,
    "node_failure": _node_failure,
    "batch_decode_chain": _decode_chain,
}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_node_equals_reference(workload, seed):
    ref, port = (WORKLOADS[workload](_pkg(p), seed) for p in PACKAGES)
    assert port == ref
    assert ref["runs"], "the workload ran no invocation"


def test_workloads_exercise_their_paths():
    """Each workload reaches what it is meant to test, in the port."""
    P = _pkg("repro_torch")
    retry = _timeout_retry(P, 0)
    assert retry["retries"] > 0 and any(not r[0] for r in retry["runs"])
    hedge = _hedging(P, 0)
    assert len(hedge["submits"]) > 5 * 8  # fan + 6 doubles + sum per run, plus hedges
    fail = _node_failure(P, 0)
    assert any(r[0] and "node_failure" in r[0] for r in fail["runs"])
    miss = _random_dags(P, 0, cache_miss_rate=0.3, code_cache_entries=2)
    assert miss["latency"] != _random_dags(P, 0)["latency"]
    batch = _decode_chain(P, 0)
    assert any(s[1] == "batch" for s in batch["submits"])
    assert batch["weights"]["cold_touches"] > 0
    for run in (retry, hedge, fail, miss):
        assert run["committed_end"] == 0
    assert batch["committed_end"] == batch["resident_bytes"]


# ------------------------------------------------------ composition checks
def _simple_comp(P):
    c = P.dag.Composition("c")
    a = c.compute("a", "fa", inputs=("x",), outputs=("y",))
    b = c.compute("b", "fb", inputs=("y",), outputs=("z",))
    c.edge(a["y"], b["y"], "all")
    c.bind_input("x", a["x"])
    c.bind_output("z", b["z"])
    return c


def _cycle(P):
    c = P.dag.Composition("cyc")
    a = c.compute("a", "fa", inputs=("x",), outputs=("y",))
    b = c.compute("b", "fb", inputs=("y",), outputs=("z",))
    c.edge(a["y"], b["y"])
    c.edges.append(type(c.edges[0])(b["z"], a["x"], "all"))
    c.bind_input("x", a["x"])
    c.validate()


def _unfed(P):
    c = P.dag.Composition("u")
    c.compute("a", "fa", inputs=("x",), outputs=("y",))
    c.validate()


def _double_fan_in(P):
    c = P.dag.Composition("d")
    a = c.compute("a", "fa", inputs=("x",), outputs=("y", "w"))
    b = c.compute("b", "fb", inputs=("y", "w"), outputs=("z",))
    c.edge(a["y"], b["y"], "each")
    c.edge(a["w"], b["w"], "key")
    c.bind_input("x", a["x"])
    c.validate()


def _bad_edge_set(P):
    c = P.dag.Composition("e")
    a = c.compute("a", "fa", inputs=("x",), outputs=("y",))
    b = c.compute("b", "fb", inputs=("y",), outputs=("z",))
    c.edge(a["x"], b["y"])


def _bad_mode(P):
    c = _simple_comp(P)
    c.edge(c.vertices["a"]["y"], c.vertices["b"]["y"], "some")


def _duplicate_vertex(P):
    c = _simple_comp(P)
    c.compute("a", "fa", inputs=("x",), outputs=("y",))


def _unregistered_function(P):
    P.core.FunctionRegistry().register_composition(_simple_comp(P))


INVALID = {"cycle": _cycle, "unfed": _unfed, "double_fan_in": _double_fan_in,
           "bad_edge_set": _bad_edge_set, "bad_mode": _bad_mode,
           "duplicate_vertex": _duplicate_vertex,
           "unregistered_function": _unregistered_function}


@pytest.mark.parametrize("case", sorted(INVALID))
def test_composition_validation_errors_equal_reference(case):
    errors = []
    for p in PACKAGES:
        with pytest.raises(ValueError) as exc:
            INVALID[case](_pkg(p))
        errors.append(str(exc.value))
    assert errors[0] == errors[1]


def test_composition_topology_equals_reference():
    ref, port = (_simple_comp(_pkg(p)) for p in PACKAGES)
    port.validate()
    assert port.topo_order() == ref.topo_order()
    for P in map(_pkg, PACKAGES):
        c = P.dag.Composition("i")
        a = c.compute("a", "fa", inputs=("x",), outputs=("y",))
        h = c.http("h")
        c.edge(a["y"], h["requests"])
        c.bind_input("x", a["x"])
        assert c.io_intensity() == 0.5


# ------------------------------------------------------------ fingerprints
FINGERPRINTED = {
    "bytes": b"\x00\x01payload",
    "str": "tokens",
    "int": 7,
    "float": 0.25,
    "bool": True,
    "none": None,
    "int32_array": np.arange(12, dtype=np.int32).reshape(3, 4),
    "float32_array": np.linspace(0, 1, 9, dtype=np.float32),
}


@pytest.mark.parametrize("kind", sorted(FINGERPRINTED))
def test_fingerprints_equal_reference(kind):
    data = FINGERPRINTED[kind]
    fps = [_pkg(p).items.fingerprint_sets({"x": [_pkg(p).items.Item(data, key="k")],
                                           "y": [_pkg(p).items.Item(b"tail")]})
           for p in PACKAGES]
    assert fps[0] is not None and fps[0] == fps[1]
    items = [_pkg(p).items.Item(data, key="k") for p in PACKAGES]
    assert items[0].nbytes == items[1].nbytes


def test_tensor_items_are_opaque():
    """A tensor has its size but no fingerprint: the memo then runs the
    payload (hashing a CUDA tensor would copy it to the host every call)."""
    P = _pkg("repro_torch")
    t = torch.ones(4, 8, dtype=torch.float32)
    it = P.items.Item(t)
    assert it.nbytes == 128 and it.content_fp is None
    assert P.items.fingerprint_sets({"x": [P.items.Item(b"a"), it]}) is None
    memo = P.core.PayloadMemo()
    reg = P.core.FunctionRegistry()
    cf = reg.register_function("ident", lambda ins: {"out": list(ins["x"])})
    for _ in range(2):
        memo.run(cf, {"x": [it]})
    assert (memo.skips, memo.hits, memo.misses) == (2, 0, 0)
