"""The port's apps (``repro_torch.apps``), serving cost models
(``repro_torch.launch.hlo_analysis``) and ``configs.paper_micro`` against the
reference's, with ``==``.

The inference service is registered in both packages on the same hardware
constants (the port's ``HardwareSpec`` carrying ``TPU_V5E``'s three rates),
so its profiles, batch models, weight cold start and request compositions
must be equal field for field, and a modeled ``WorkerNode`` run of the same
requests from the same seeds must give the same tokens and the same virtual
latencies, batched and unbatched. The log-processing app compiles to the
same IR and runs to the same outputs and latencies on ``sdk.Platform``.
"""
import dataclasses
import importlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.config.parallel import TPU_V5E  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro_torch.config.parallel import H100_SXM, HardwareSpec  # noqa: E402
from repro_torch.launch import hlo_analysis  # noqa: E402

PACKAGES = ("repro", "repro_torch")
# the port's HardwareSpec at the reference's default rates, so both packages price alike
TPU_RATES = HardwareSpec(name="tpu-v5e-rates", peak_flops=TPU_V5E.peak_flops,
                         hbm_bandwidth=TPU_V5E.hbm_bandwidth, ici_bandwidth=TPU_V5E.ici_bandwidth)


def _pkg(name: str) -> types.SimpleNamespace:
    mod = lambda m: importlib.import_module(f"{name}.{m}")
    return types.SimpleNamespace(
        name=name, core=mod("core"), sdk=mod("sdk"), apps=mod("apps"),
        svc=mod("apps.inference_service"), hlo=mod("launch.hlo_analysis"),
        configs=mod("configs"), micro=mod("configs.paper_micro"))


REF, PORT = (_pkg(p) for p in PACKAGES)


def _hw(P):
    return {} if P is REF else {"hw": TPU_RATES}


def _plain(x):
    """A dataclass (of either package) as (class name, fields), recursively, so
    objects of the two packages compare with ``==``."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            (f.name, _plain(getattr(x, f.name))) for f in dataclasses.fields(x))
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    return x


# ------------------------------------------------------------ cost models
ROOFLINE_CASES = [
    dict(chips=1, flops_per_device=2.6e12, hbm_bytes_per_device=1.6e10,
         collective_link_bytes_per_device=0.0, collective_operand_bytes_per_device=0.0,
         peak_flops=989e12, hbm_bw=3.35e12, ici_bw=900e9, model_flops=2.6e12),
    dict(chips=256, flops_per_device=1e15, hbm_bytes_per_device=3e11,
         collective_link_bytes_per_device=5e10, collective_operand_bytes_per_device=7e10,
         peak_flops=197e12, hbm_bw=819e9, ici_bw=100e9, model_flops=0.0),
    dict(chips=4, flops_per_device=1.0, hbm_bytes_per_device=1.0,
         collective_link_bytes_per_device=1e12, collective_operand_bytes_per_device=1e12,
         peak_flops=1e12, hbm_bw=1e12, ici_bw=1e9, model_flops=3.0),
]


@pytest.mark.parametrize("case", range(len(ROOFLINE_CASES)))
def test_roofline_terms_match_reference(case):
    kw = ROOFLINE_CASES[case]
    got, want = PORT.hlo.RooflineTerms(**kw), REF.hlo.RooflineTerms(**kw)
    assert got.to_json() == want.to_json()
    assert (got.bottleneck, got.step_time_s, got.mfu) == (want.bottleneck, want.step_time_s, want.mfu)


@pytest.mark.parametrize("batch", [1, 3, 64])
def test_serving_step_terms_and_weight_cold_start_match_reference(batch):
    kw = dict(param_bytes=1.6e10, flops_per_seq=1.6e10, kv_bytes_per_seq=2.6e7, batch=batch,
              peak_flops=989e12, hbm_bw=3.35e12, ici_bw=900e9)
    assert (PORT.hlo.serving_step_terms(**kw).to_json()
            == REF.hlo.serving_step_terms(**kw).to_json())
    est = dict(hlo_ops=100 * batch, disk_bandwidth_bps=3e9, compile_s_per_op=1e-3)
    got = PORT.hlo.weight_coldstart_estimate(2.6e9 * batch, **est)
    want = REF.hlo.weight_coldstart_estimate(2.6e9 * batch, **est)
    assert _plain(got)[1:] == _plain(want)[1:]
    assert (got.load_s, got.compile_s, got.total_s) == (want.load_s, want.compile_s, want.total_s)
    assert PORT.hlo.weight_coldstart_estimate(1e9).hlo_ops == 0


def test_count_graph_ops_counts_an_exported_mlp():
    """Two Linear layers and a ReLU export to three operator calls; the estimate
    then prices that count in place of the caller's."""
    mlp = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(), torch.nn.Linear(16, 4))
    exported = torch.export.export(mlp, (torch.randn(2, 8),))
    targets = [str(n.target) for n in exported.graph.nodes if n.op == "call_function"]
    assert hlo_analysis.count_graph_ops(exported) == len(targets) == 3
    assert sum("linear" in t for t in targets) == 2
    wc = hlo_analysis.weight_coldstart_estimate(1e9, exported=exported, hlo_ops=999)
    assert wc.hlo_ops == 3 and wc.compile_s == 3 * 2e-3


# ------------------------------------------------------------ LMSpec
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_lm_spec_from_config_matches_reference(arch):
    got = PORT.svc.lm_spec_from_config(PORT.configs.get_config(arch))
    want = REF.svc.lm_spec_from_config(REF.configs.get_config(arch))
    assert _plain(got) == _plain(want)
    for prop in ("param_bytes", "kv_bytes_per_token", "flops_per_token", "hlo_ops_estimate"):
        assert getattr(got, prop) == getattr(want, prop), prop
    over = dict(name="x", seq_len_hint=512)
    assert (_plain(PORT.svc.lm_spec_from_config(PORT.configs.get_smoke(arch), **over))
            == _plain(REF.svc.lm_spec_from_config(REF.configs.get_smoke(arch), **over)))


# ------------------------------------------------------------ the service
def _service(P, spec=None, **kw):
    reg = P.core.FunctionRegistry()
    return reg, P.svc.register_inference_service(reg, spec or P.svc.LMSpec(), **_hw(P), **kw)


@pytest.mark.parametrize("prefill_chunk", [None, 32])
def test_register_inference_service_matches_reference(prefill_chunk):
    (preg, got), (rreg, want) = (_service(P, prefill_chunk=prefill_chunk) for P in (PORT, REF))
    assert got.fn_names == want.fn_names
    assert _plain(got.profiles) == _plain(want.profiles)
    assert _plain(got.batch_model) == _plain(want.batch_model)
    assert _plain(got.batch_models) == _plain(want.batch_models)
    assert sorted(got.batch_models) == sorted(want.batch_models)
    assert _plain(got.weight_cold)[1:] == _plain(want.weight_cold)[1:]
    assert (got.prefill_step_s, got.decode_step_s) == (want.prefill_step_s, want.decode_step_s)
    assert got.prefill_chunk == want.prefill_chunk
    assert sorted(preg.functions) == sorted(rreg.functions)
    for name, spec in got.specs.items():
        ref = want.specs[name]
        assert (spec.name, spec.inputs, spec.outputs, spec.batchable, spec.context_bytes) == \
               (ref.name, ref.inputs, ref.outputs, ref.batchable, ref.context_bytes)
        assert _plain(spec.profile) == _plain(ref.profile)
    ws_got, ws_want = got.make_weight_store(keepalive_s=0.5), want.make_weight_store(keepalive_s=0.5)
    assert (_plain(ws_got._models), ws_got._by_fn) == (_plain(ws_want._models), ws_want._by_fn)


def test_service_prices_on_the_card_by_default():
    """Without ``hw`` the port prices on H100_SXM's rates."""
    reg = PORT.core.FunctionRegistry()
    spec = PORT.svc.lm_spec_from_config(PORT.configs.get_config("granite-8b"))
    svc = PORT.svc.register_inference_service(reg, spec)
    m = svc.batch_model
    assert (m.peak_flops, m.hbm_bw) == (H100_SXM.peak_flops, H100_SXM.hbm_bandwidth)
    assert svc.decode_step_s == pytest.approx(
        (spec.param_bytes + spec.seq_len_hint * spec.kv_bytes_per_token) / H100_SXM.hbm_bandwidth
        + m.overhead_s, rel=1e-12)


def _ir(comp):
    return (comp.name, _plain(list(comp.vertices.items())), _plain(comp.edges),
            _plain(comp.input_bindings), _plain(comp.output_bindings),
            {v: (_plain(comp.in_edges(v)), _plain(comp.out_edges(v))) for v in comp.vertices})


@pytest.mark.parametrize("p,d,chunk", [(32, 8, None), (77, 1, None), (128, 32, 48), (40, 0, 16)])
def test_request_composition_matches_reference_and_sdk_compile(p, d, chunk):
    (preg, psvc), (_, rsvc) = (_service(P, prefill_chunk=chunk) for P in (PORT, REF))
    got = PORT.svc.build_request_composition(psvc.spec, prompt_len=p, n_decode=d,
                                             prefill_chunk=chunk)
    want = REF.svc.build_request_composition(rsvc.spec, prompt_len=p, n_decode=d,
                                             prefill_chunk=chunk)
    assert _ir(got) == _ir(want)
    sdk_comp = PORT.svc.request_app(psvc.spec, prompt_len=p, n_decode=d,
                                    prefill_chunk=chunk).compile(preg)
    assert list(got.vertices) == list(sdk_comp.vertices)
    for name in got.vertices:
        assert got.vertices[name] == sdk_comp.vertices[name], name
    assert got.edges == sdk_comp.edges
    assert (got.input_bindings, got.output_bindings) == \
           (sdk_comp.input_bindings, sdk_comp.output_bindings)
    got.validate()


@pytest.mark.parametrize("n_decode", [0, 5, 31])
def test_expected_tokens_match_reference(n_decode):
    for i, prompt in enumerate((b"a", b"hello world " * 7, bytes(range(200)))):
        spec_p = PORT.svc.LMSpec(vocab_size=32_000 + 17 * i)
        spec_r = REF.svc.LMSpec(vocab_size=32_000 + 17 * i)
        assert (PORT.svc.expected_tokens(prompt, spec_p, n_decode)
                == REF.svc.expected_tokens(prompt, spec_r, n_decode))


def _requests(n=6, seed=0):
    """tests/test_inference_service.py's requests."""
    rng = np.random.default_rng(seed)
    out = []
    for rid in range(n):
        p = int(rng.integers(8, 24))
        d = int(rng.integers(3, 9))
        out.append((0.01 * rid, (f"req{rid}:".encode() * p)[: 4 * p], p, d))
    return out


def _node_run(P, batch_slots, max_batch):
    """tests/test_inference_service.py's modeled node run in package ``P``:
    per prompt its tokens, virtual latency and end time, and the node's
    committed-memory timeline."""
    core = P.core
    reg, svc = _service(P)
    loop = core.EventLoop()
    node = core.WorkerNode(reg, loop=loop, num_slots=6, profiles=svc.profiles,
                           batch_slots=batch_slots, batch_model=svc.batch_model,
                           max_batch=max_batch, weight_store=svc.make_weight_store(keepalive_s=0.5),
                           seed=1)
    results = {}
    for t, prompt, p, d in _requests():
        comp = P.svc.build_request_composition(svc.spec, prompt_len=p, n_decode=d)

        def done(inv, prompt=prompt):
            assert not inv.failed, inv.failed
            results[prompt] = inv
        loop.after(t, lambda c=comp, pr=prompt, cb=done: node.invoke(
            c, {"prompt": [core.Item(pr)]}, cb))
    loop.run()
    toks = lambda inv: [int(t) for t in inv.outputs["text"][0].data.decode()[4:].split(",")]
    return ({pr: (toks(inv), inv.latency, inv.t_end) for pr, inv in results.items()},
            list(node.tracker.timeline.points))


@pytest.mark.parametrize("batch_slots,max_batch", [(1, 16), (1, 1), (0, 16)],
                         ids=["batched", "serialized", "unbatched"])
def test_worker_node_run_matches_reference(batch_slots, max_batch):
    got, want = (_node_run(P, batch_slots, max_batch) for P in (PORT, REF))
    assert got == want
    for _, prompt, _, d in _requests():
        assert got[0][prompt][0] == PORT.svc.expected_tokens(prompt, PORT.svc.LMSpec(), d)


# ------------------------------------------------------------ log processing
def test_log_processing_app_compiles_to_the_reference_ir():
    assert _ir(PORT.apps.log_processing_app().compile()) == \
           _ir(REF.apps.log_processing_app().compile())
    specs = lambda P: [(s.name, s.inputs, s.outputs) for s in P.apps.log_processing_app().function_specs()]
    assert specs(PORT) == specs(REF)


def _log_platform_run(P, shards):
    sdk, core = P.sdk, P.core
    platform = sdk.Platform(node=sdk.NodeSpec(num_slots=4, comm_slots=1, seed=3))
    comp = P.apps.build_log_processing(platform.registry, platform.services, shards=shards)
    profiles = {name: core.ColdStartProfile(1e-4, 3e-4 * (i + 1), jitter_sigma=0.2)
                for i, name in enumerate(("access", "fanout", "render"))}
    platform.deploy(comp, profiles=profiles)
    handles = [platform.invoke(comp, {"token": [core.Item(f"tok{i}")]}, at=i * 1e-3)
               for i in range(12)]
    platform.run()
    return ([(h.result()["result"][0].data, h.latency) for h in handles],
            _ir(comp), platform.latency.summary())


@pytest.mark.parametrize("shards", [1, 3])
def test_build_log_processing_on_a_platform_matches_reference(shards):
    got, want = (_log_platform_run(P, shards) for P in (PORT, REF))
    assert got == want
    assert all(b"rendered" in out for out, _ in got[0])


# ------------------------------------------------------------ paper_micro
@pytest.mark.parametrize("ctor,args", [("matmul_1x1", ()), ("matmul_128", ()),
                                       ("fetch_compute", ()), ("fetch_compute", (3,)),
                                       ("image_compress", ())])
def test_paper_micro_configs_match_reference(ctor, args):
    got, want = getattr(PORT.micro, ctor)(*args), getattr(REF.micro, ctor)(*args)
    assert _plain(got) == _plain(want)
