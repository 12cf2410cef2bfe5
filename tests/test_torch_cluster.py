"""The port's cluster modules against the reference's on modeled workloads.

Short windows of the fig11, fig12 and fig15 benchmarks
(``benchmarks/fig1*.py``, same knobs, cut in time) and a fig10-style
``KeepWarmPlatform`` run go through ``repro.sdk`` / ``repro.core`` and
through ``repro_torch.sdk`` / ``repro_torch.core``, each built from the
same seeds:

  * fig11: elastic scale-out under ON/OFF bursts from ``core.trace``
    (``ElasticControlPlane``, ``ClusterManager``);
  * fig12: cross-node placement of a fan-out DAG over a static pool with a
    ``TransferProfile`` (``CrossNodePlacer``, ``TransferStats``);
  * fig15: a cold join of fresh nodes warmed by ``P2PDistributor``
    prefetch, peer-to-peer and origin-only, and a predicted burst
    (``BurstPredictor``);
  * fig10: the Knative-style keep-warm baseline.

The simulator is deterministic, so latencies, committed bytes, node-count
timelines, routing and transfer stats and journals must be equal with
``==``. The ``core.trace`` generators' arrays are compared with
``np.array_equal``.
"""
import dataclasses
import importlib
import types

import numpy as np
import pytest

pytest.importorskip("torch")

PACKAGES = ("repro", "repro_torch")


def _pkg(name: str) -> types.SimpleNamespace:
    return types.SimpleNamespace(sdk=importlib.import_module(f"{name}.sdk"),
                                 core=importlib.import_module(f"{name}.core"),
                                 sim=importlib.import_module(f"{name}.core.sim"),
                                 trace=importlib.import_module(f"{name}.core.trace"))


def _both(workload, *args):
    ref, port = (workload(_pkg(name), *args) for name in PACKAGES)
    assert port == ref
    return port


def _transfer_stats(stats):
    """A ``TransferStats`` as plain values (its class differs per package)."""
    if stats is None:
        return None
    return (stats.local_placements, stats.remote_placements,
            sorted((k, dataclasses.astuple(v)) for k, v in stats.links.items()))


# ------------------------------------------------------------------ trace
@pytest.mark.parametrize("kw", [
    dict(n=100, seed=0, total_rate_hz=50.0),
    dict(n=30, seed=0, total_rate_hz=70.0, burst_period_range=(30.0, 90.0),
         burst_duty_range=(0.15, 0.4), exec_median_s=0.060, stagger_bursts=True),
    dict(n=12, seed=7, zipf_s=0.8, exec_median_s=0.2),
], ids=("fig10", "fig11", "flat"))
def test_trace_generators_equal(kw):
    kw = dict(kw)
    n = kw.pop("n")
    got = []
    for name in PACKAGES:
        trace = _pkg(name).trace
        fns = trace.generate_functions(n, **kw)
        events = trace.generate_events(fns, 30.0, seed=1)
        got.append((fns, events))
    (rf, re_), (pf, pe) = got
    assert [dataclasses.astuple(f) for f in pf] == [dataclasses.astuple(f) for f in rf]
    for field in ("t", "exec_s"):
        assert np.array_equal(np.array([getattr(e, field) for e in pe]),
                              np.array([getattr(e, field) for e in re_]))
    assert [e.fn for e in pe] == [e.fn for e in re_]
    assert len(pe) > 100


def test_trace_replay_equal():
    def run(P):
        loop = P.sim.EventLoop()
        fns = P.trace.generate_functions(10, seed=3)
        seen = []
        P.trace.replay(loop, P.trace.generate_events(fns, 20.0, seed=4),
                       lambda e: seen.append((loop.now, e.fn, e.exec_s)))
        loop.run()
        return seen

    assert len(_both(run)) > 10


# ------------------------------------------------------------------ fig11
FIG11_WINDOW_S = 40.0   # the benchmark's --quick window


def _fig11(P, max_nodes: int):
    """fig11's elastic platform (6 nodes of 8 slots, 12-entry code caches, 256
    MiB base, 0.75 s boots) on the first ``FIG11_WINDOW_S`` of its trace."""
    sdk, Item = P.sdk, P.core.Item
    fns = P.trace.generate_functions(30, seed=0, total_rate_hz=70.0,
                                     burst_period_range=(30.0, 90.0),
                                     burst_duty_range=(0.15, 0.4), exec_median_s=0.060,
                                     stagger_bursts=True)
    events = P.trace.generate_events(fns, FIG11_WINDOW_S, seed=1)
    cfg = sdk.ControlPlaneConfig(
        min_nodes=1, max_nodes=max_nodes, target_outstanding_per_node=12.0,
        max_queue_delay_s=100e-3, keepalive_s=2.0, tick_interval_s=0.25,
        node_boot=sdk.ColdStartProfile(setup_s=0.75, execute_s=0.0, jitter_sigma=0.1),
        node_base_bytes=256 << 20)
    platform = sdk.Platform(elastic=sdk.Elastic(
        config=cfg, seed=2, journal=True,
        node=sdk.NodeSpec(num_slots=8, code_cache_entries=12, base_bytes=256 << 20, seed=20)))
    comps = {}
    for f in fns:
        spec = sdk.declare(f.name, lambda ins: {"out": [Item(1)]}, inputs=("x",),
                           outputs=("out",), context_bytes=f.context_bytes,
                           profile=sdk.ColdStartProfile(0.3e-3, f.exec_median_s,
                                                        jitter_sigma=f.exec_sigma))
        comps[f.name] = platform.deploy(sdk.single_function_app(spec))
    lat = []
    platform.submit_stream((e.t, comps[e.fn], {"x": [Item(0)]},
                            lambda inv: lat.append((inv.failed, inv.latency)))
                           for e in events)
    platform.run(until=FIG11_WINDOW_S)
    platform.run()
    cp = platform.control_plane
    return {"events": len(events), "lat": lat, "summary": platform.latency.summary(),
            "cp": cp.summary(FIG11_WINDOW_S), "timeline": list(cp.node_count_timeline.points),
            "journal": list(cp.journal), "nodes": [n.name for n in platform.nodes]}


@pytest.mark.parametrize("max_nodes", (2, 6))
def test_fig11_elastic_window_equal(max_nodes):
    got = _both(_fig11, max_nodes)
    assert got["events"] > 500 and len(got["lat"]) == got["events"]
    assert got["cp"]["scale_ups"] >= 1 and got["cp"]["nodes_peak"] <= max_nodes


# ------------------------------------------------------------------ fig12
def _fig12(P, width: int, crossnode: bool):
    """fig12's fan-out DAG (src -> b0..b{W-1} of 16 MiB contexts -> join) over 4
    nodes of 4 slots, 512 KiB payloads on a 100 us / 1.25 GB/s link, 6 arrivals
    a second for 3 s."""
    sdk, Item = P.sdk, P.core.Item
    src = sdk.declare("src", lambda ins: {"out": [Item(b"x" * (512 << 10))]}, inputs=("x",),
                      outputs=("out",), profile=sdk.ColdStartProfile(0.3e-3, 1e-3, 0.0))
    join = sdk.declare("join", lambda ins: {"out": [Item("|".join(sorted(
        i.data for i in ins["xs"])))]}, inputs=("xs",), outputs=("out",),
        profile=sdk.ColdStartProfile(0.3e-3, 2e-3, 0.0))
    branches = [sdk.declare(f"b{k}", lambda ins, k=k: {"out": [Item(
        f"b{k}:{len(ins['xs'][0].data)}")]}, inputs=("xs",), outputs=("out",),
        context_bytes=16 << 20, profile=sdk.ColdStartProfile(0.3e-3, 25e-3, 0.0))
        for k in range(width)]
    with sdk.composition(f"fanout{width}") as app:
        sv = src(x=app.input("x"))
        j = join()
        for spec in branches:
            j.feed(xs=spec(xs=sv.out).out)
        app.output("result", j.out)
    platform = sdk.Platform(
        pool=[sdk.NodeSpec(num_slots=4, seed=30 + i, name=f"n{i}") for i in range(4)],
        crossnode=crossnode,
        transfer_profile=sdk.TransferProfile(latency_s=100e-6, bandwidth_bps=1.25e9))
    comp = platform.deploy(app)
    out = []
    platform.submit_stream((i / 6.0, comp, {"x": [Item(b"go")]},
                            lambda inv: out.append((inv.failed, inv.latency,
                                                    inv.outputs["result"][0].data)))
                           for i in range(18))
    platform.run()
    nodes = platform.nodes
    return {"out": out, "summary": platform.latency.summary(),
            "committed": [(n.committed_avg_bytes, n.committed_peak_bytes,
                           n.tracker.timeline.peak()) for n in nodes],
            "merged_peak": P.sim.merged_peak([n.tracker.timeline for n in nodes]),
            "transfers": _transfer_stats(platform.placer.stats if platform.placer else None)}


@pytest.mark.parametrize("width", (4, 8))
@pytest.mark.parametrize("crossnode", (False, True), ids=("local", "crossnode"))
def test_fig12_crossnode_window_equal(width, crossnode):
    got = _both(_fig12, width, crossnode)
    assert len(got["out"]) == 18 and not any(f for f, _, _ in got["out"])
    if crossnode:
        assert got["transfers"][1] > 0     # remote placements, charged transfers
        assert sum(counters[2] for _, counters in got["transfers"][2]) > 0
    else:
        assert got["transfers"] is None


# ------------------------------------------------------------------ fig15
def _fig15_join(P, peer: bool):
    """fig15 segment A, warmed for 3 s: two seed nodes (10 functions on two 48
    MiB models) adopt 4 fresh nodes, prefetched from peers or the origin."""
    sdk, Item = P.sdk, P.core.Item

    def store():
        ws = sdk.WeightStore(keepalive_s=60.0)
        ws.register("join_model_a", 48 << 20, tuple(f"joinfn{i}" for i in range(5)))
        ws.register("join_model_b", 48 << 20, tuple(f"joinfn{i}" for i in range(5, 10)))
        return ws

    def spec(seed):
        return sdk.NodeSpec(num_slots=8, code_cache_entries=16, base_bytes=256 << 20,
                            seed=seed, weight_store=store)

    platform = sdk.Platform(
        elastic=sdk.Elastic(config=sdk.ControlPlaneConfig(
            min_nodes=2, max_nodes=2, keepalive_s=120.0, node_base_bytes=256 << 20),
            seed=3, node=spec(30)),
        config=sdk.PlatformConfig(prefetch=sdk.PrefetchConfig(hot_k=12, fanout=2, peer=peer,
                                                               journal=True)))
    comps = [platform.deploy(sdk.single_function_app(sdk.declare(
        f"joinfn{i}", lambda ins: {"out": [Item(1)]}, inputs=("x",), outputs=("out",),
        profile=sdk.ColdStartProfile(0.3e-3, 0.020, jitter_sigma=0.2)))) for i in range(10)]
    rng = np.random.default_rng(7)
    t, arrivals = 0.0, []
    while True:
        t += rng.exponential(1.0 / 40.0)
        if t >= 3.0:
            break
        arrivals.append((t, comps[int(rng.integers(10))], {"x": [Item(0)]}))
    platform.submit_stream(arrivals)
    cluster = platform.cluster
    platform.loop.at(3.0, lambda: [cluster.add_node(spec(100 + k).build(
        platform, name=f"join{k}")) for k in range(4)])
    platform.run()
    dist = platform.distributor
    return {"summary": dist.summary(), "join_log": list(dist.join_log),
            "journal": list(dist.journal), "latency": platform.latency.summary(),
            "transfers": _transfer_stats(dist.stats),
            "nodes": [n.name for n in platform.nodes]}


@pytest.mark.parametrize("peer", (True, False), ids=("p2p", "origin"))
def test_fig15_prefetch_join_equal(peer):
    got = _both(_fig15_join, peer)
    assert len(got["join_log"]) == 4 and got["summary"]["artifacts"] > 0
    assert (got["summary"]["peer_fetches"] > 0) == peer


def _fig15_burst(P):
    """fig15 segment B's predictive platform on a 2 s ON/OFF period (duty 0.25,
    40 arrivals a second while ON) over 14 s: ``BurstPredictor`` boots nodes
    ahead of each predicted edge and ``P2PDistributor`` warms them."""
    sdk, Item = P.sdk, P.core.Item
    fn = P.trace.TraceFunction(name="burstfn", rate_hz=10.0, exec_median_s=0.2,
                               exec_sigma=0.3, context_bytes=1 << 20, burst_period_s=2.0,
                               burst_duty=0.25)
    events = P.trace.generate_events([fn], 14.0, seed=11)

    def store():
        ws = sdk.WeightStore(keepalive_s=4.0)
        ws.register("burst_model", 32 << 20, ("burstfn",))
        return ws

    platform = sdk.Platform(
        elastic=sdk.Elastic(config=sdk.ControlPlaneConfig(
            min_nodes=1, max_nodes=4, target_outstanding_per_node=12.0,
            max_queue_delay_s=100e-3, keepalive_s=0.5, tick_interval_s=0.25,
            node_boot=sdk.ColdStartProfile(setup_s=0.75, execute_s=0.0, jitter_sigma=0.1),
            node_base_bytes=256 << 20), seed=5, journal=True,
            node=sdk.NodeSpec(num_slots=8, code_cache_entries=16, base_bytes=256 << 20,
                              seed=40, weight_store=store)),
        config=sdk.PlatformConfig(
            prefetch=sdk.PrefetchConfig(hot_k=12, fanout=2, peer=True),
            predictor=sdk.PredictorConfig(bin_s=0.25, alpha=0.2, on_factor=1.5, min_cycles=2,
                                          lead_s=0.5, nodes_ahead=3)))
    comp = platform.deploy(sdk.single_function_app(sdk.declare(
        "burstfn", lambda ins: {"out": [Item(1)]}, inputs=("x",), outputs=("out",),
        context_bytes=1 << 20, profile=sdk.ColdStartProfile(
            0.3e-3, 0.2, jitter_sigma=0.3, cold_setup_s=0.5))))
    lat = []
    platform.submit_stream((e.t, comp, {"x": [Item(0)]}, lambda inv: lat.append(inv.latency))
                           for e in events)
    platform.run()
    cp = platform.control_plane
    return {"lat": lat, "predictor": cp.predictor.summary(), "cp": cp.summary(14.0),
            "timeline": list(cp.node_count_timeline.points), "journal": list(cp.journal),
            "prefetch": platform.distributor.summary()}


def test_fig15_predicted_burst_equal():
    got = _both(_fig15_burst)
    assert got["predictor"]["fired"] > 0 and got["cp"]["scale_ups"] > 0


# ------------------------------------------------------------------ fig10
def _fig10_keepwarm(P, hot_ratio):
    """fig10's keep-warm baseline (16 cores, 128 MiB guest OS, snapshot boots of
    15 ms, 60 s keep-alive) on 60 s of its trace."""
    loop = P.sim.EventLoop()
    kw = P.core.KeepWarmPlatform(loop, cores=16, guest_os_bytes=128 << 20, keepalive_s=60.0,
                                 hot_ratio=hot_ratio, seed=2)
    fns = P.trace.generate_functions(100, seed=0, total_rate_hz=50.0)
    for f in fns:
        kw.register(f.name, P.core.ColdStartProfile(15e-3, f.exec_median_s),
                    context_bytes=f.context_bytes)
    kw.request_stream((e.t, e.fn) for e in P.trace.generate_events(fns, 60.0, seed=1))
    loop.run(until=60.0)
    return {"summary": kw.latency.summary(), "cold": kw.cold_count, "warm": kw.warm_count,
            "avg": kw.committed_avg_bytes, "peak": kw.tracker.timeline.peak()}


@pytest.mark.parametrize("hot_ratio", (None, 0.5))
def test_fig10_keepwarm_equal(hot_ratio):
    got = _both(_fig10_keepwarm, hot_ratio)
    assert got["cold"] > 0 and got["warm"] > 0
