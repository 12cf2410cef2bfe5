"""Serving-on-Dandelion: batched LM inference as a composition workload.

Counterpart of ``repro.apps.inference_service``, priced on the card's
constants (``config.parallel.H100_SXM``) where the reference prices on a
TPU's. The paper's core claim is that cloud-native apps — user logic plus
higher-level services like AI inference — can run as DAGs of pure
functions over the elastic platform, booting sandboxes per request. This
module expresses one LM serving request as exactly that:

    tokenize -> prefill -> decode_0 -> ... -> decode_{N-1} -> detokenize

Every vertex is a pure compute function; the KV cache rides between the
prefill/decode vertices as a ``KVCache`` item inside the ordinary
``MemoryContext`` dataflow, so its *real byte size* is what the platform
commits, and — under cross-node placement — what a cache migration
charges to the producing node's comm engine (``TransferProfile`` on
``KVCache.nbytes`` bytes).

Costs are priced from the ``repro_torch.launch.hlo_analysis`` models:

  * model-weight cold start (param bytes / disk bandwidth + compile time
    from the operation count of a ``torch.export`` program, or the
    layer-count estimate) becomes the prefill/decode functions'
    ``ColdStartProfile.cold_setup_s``, charged only when the executing
    node holds no resident weights (``core.workloads.WeightStore``);
  * per-step execute time comes from ``serving_step_terms`` rooflines;
    the same terms parameterize the platform's ``BatchStepModel`` so a
    batching engine coalesces co-resident decode steps into one step.

Token streams are deterministic functions of the prompt digest, so runs
are byte-stable and batching on/off produces identical tokens (the port's
against the reference's: tests/test_torch_apps.py).
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch import sdk
from repro_torch.config.parallel import H100_SXM, HardwareSpec
from repro_torch.core import (
    BatchStepModel,
    ColdStartProfile,
    Composition,
    FunctionRegistry,
    Item,
    WeightStore,
)
from repro_torch.core.dag import COMPUTE, Edge, PortRef, Vertex
from repro_torch.launch.hlo_analysis import (
    WeightColdStart,
    serving_step_terms,
    weight_coldstart_estimate,
)

SANDBOX_SETUP_S = 0.3e-3      # dandelion context-bind path (Table 1)


@dataclass(frozen=True)
class LMSpec:
    """Model geometry the cost models need (nothing else)."""

    name: str = "lm-1b"
    n_params: float = 1.3e9
    n_layers: int = 24
    d_model: int = 2048
    vocab_size: int = 32_000
    dtype_bytes: int = 2          # bf16 weights + KV
    ops_per_layer: int = 60       # compiled-op estimate per layer
    prompt_len_hint: int = 128    # representative shapes for profiles
    seq_len_hint: int = 160

    @property
    def param_bytes(self) -> int:
        return int(self.n_params * self.dtype_bytes)

    @property
    def kv_bytes_per_token(self) -> int:
        return 2 * self.n_layers * self.d_model * self.dtype_bytes  # K + V

    @property
    def flops_per_token(self) -> float:
        return 2.0 * self.n_params

    @property
    def hlo_ops_estimate(self) -> int:
        return self.n_layers * self.ops_per_layer + 40  # + embed/head/sample


def lm_spec_from_config(cfg, **overrides) -> LMSpec:
    """An ``LMSpec`` priced from a ``repro_torch.configs`` ``ModelConfig``.

    The cost models only read four things off the geometry: parameter
    count, and the KV width ``2 * n_layers * d_model * dtype_bytes``.
    Real architectures use GQA, so the *true* per-token KV width is
    ``2 * n_layers * (num_kv_heads * head_dim) * dtype_bytes`` — we fold
    that in by setting the spec's ``d_model`` to the KV projection width
    rather than the residual width. ``overrides`` (e.g. ``name=``,
    ``seq_len_hint=``) pass through to the ``LMSpec`` constructor."""
    fields = dict(
        name=cfg.name,
        n_params=float(cfg.num_params()),
        n_layers=cfg.num_layers,
        d_model=cfg.num_kv_heads * cfg.resolved_head_dim,
        vocab_size=cfg.vocab_size,
    )
    fields.update(overrides)
    return LMSpec(**fields)


@dataclass(frozen=True)
class KVCache:
    """Opaque KV-cache handle carried as an item between vertices.

    Holds no real activations — only the prompt digest and length the
    pure decode function needs — but reports the *modeled* cache size
    through ``nbytes``, which is the only thing the platform reads:
    ``MemoryContext.write_set`` commits it, ``cluster.CrossNodePlacer``
    charges it per migrated edge. ``fingerprint()`` exposes the handle's
    full identity to the payload memo (``items.fingerprint_sets``), so a
    decode chain over a repeated prompt digest replays as memo hits —
    priced ``BatchStepModel`` steps with fingerprint-stable payloads,
    never re-running the token arithmetic (pinned by
    tests/test_inference_service.py and tests/test_torch_apps.py)."""

    model: str
    digest: str
    seq_len: int
    bytes_per_token: int

    @property
    def nbytes(self) -> int:
        return self.seq_len * self.bytes_per_token

    def fingerprint(self) -> bytes:
        """Content identity for the payload memo: decode is a pure
        function of exactly these four fields (token values derive from
        ``digest`` + position), so equal fingerprints imply equal
        outputs."""
        return (
            f"{self.model}:{self.digest}:{self.seq_len}:{self.bytes_per_token}"
        ).encode()


def _next_token(digest: str, position: int, vocab: int) -> int:
    h = hashlib.blake2b(f"{digest}:{position}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") % vocab


@dataclass
class InferenceService:
    """Everything a platform needs to run the workload: registered
    function names, SDK function declarations, calibrated profiles, the
    batch-step model, and the weight-store spec."""

    spec: LMSpec
    profiles: Dict[str, ColdStartProfile]
    batch_model: BatchStepModel
    weight_cold: WeightColdStart
    prefill_step_s: float
    decode_step_s: float
    fn_names: Tuple[str, ...] = ()
    # the four stage declarations, keyed "tokenize"/"prefill"/"decode"/
    # "detok" — already registered; carry their calibrated profiles
    specs: Dict[str, sdk.FunctionSpec] = field(default_factory=dict)
    # per-function batch pricing: decode always; prefill too when chunked.
    # Multiplexed platforms merge several services' dicts onto one node —
    # the engine prices each coalesced step by the step's fn_name.
    batch_models: Dict[str, BatchStepModel] = field(default_factory=dict)
    prefill_chunk: Optional[int] = None

    def make_weight_store(self, *, keepalive_s: float = 0.0,
                          pinned: bool = False,
                          capacity_bytes: Optional[int] = None) -> WeightStore:
        """A fresh per-node store holding this service's weights. The
        tokenize/detokenize frontends don't touch the model, so only
        prefill/decode are registered against it. ``capacity_bytes``
        bounds node weight RAM (``WeightStore`` evicts LRU-idle residents
        to fit — the multiplexing path)."""
        ws = WeightStore(keepalive_s=keepalive_s, pinned=pinned,
                         capacity_bytes=capacity_bytes)
        self.register_weights(ws)
        return ws

    def register_weights(self, ws: WeightStore) -> WeightStore:
        """Register this service's weights into an existing store — the
        multiplexing path, where several models' services share one
        per-node store and compete for its capacity."""
        ws.register(self.spec.name, self.spec.param_bytes,
                    (self._fn("prefill"), self._fn("decode")))
        return ws

    def _fn(self, stage: str) -> str:
        return f"{self.spec.name}_{stage}"


def register_inference_service(
    reg: FunctionRegistry,
    spec: LMSpec = LMSpec(),
    *,
    hw: HardwareSpec = H100_SXM,
    disk_bandwidth_bps: float = 2e9,
    compile_s_per_op: float = 1e-3,
    step_overhead_s: float = 150e-6,
    exported=None,
    prefill_chunk: Optional[int] = None,
) -> InferenceService:
    """Register the four serving functions and price their profiles from
    the cost models, on ``hw`` (the card's constants by default).
    ``exported`` (a ``torch.export`` program of the model, e.g. the
    snapshot backend's) refines the compile-time term by its operation
    count; without it the layer-count estimate is used.

    ``prefill_chunk`` (tokens) makes prefill *chunked*: the prefill
    function is declared batchable so it rides the BATCH engine alongside
    decode, each request occupying ``ceil(prompt_len / chunk)`` units of
    the coalesced step (``Vertex.batch_units``); a per-function
    ``BatchStepModel`` prices one chunk. Default ``None`` keeps the
    historical whole-prompt CPU prefill byte-identically."""
    if prefill_chunk is not None and prefill_chunk < 1:
        raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
    kv_bpt = spec.kv_bytes_per_token
    vocab = spec.vocab_size
    name = spec.name

    def tokenize(ins):
        prompt = ins["prompt"][0].data
        raw = prompt if isinstance(prompt, (bytes, bytearray)) else str(prompt).encode()
        digest = hashlib.blake2b(raw, digest_size=8).hexdigest()
        n = max(1, len(raw) // 4)      # ~4 bytes per token
        rng = np.random.default_rng(int(digest, 16) % (2**32))
        toks = rng.integers(0, vocab, size=n, dtype=np.int32)
        return {"tokens": [Item(toks)]}

    def prefill(ins):
        toks = ins["tokens"][0].data
        digest = hashlib.blake2b(np.asarray(toks).tobytes(), digest_size=8).hexdigest()
        kv = KVCache(name, digest, seq_len=int(np.asarray(toks).size),
                     bytes_per_token=kv_bpt)
        first = _next_token(digest, kv.seq_len, vocab)
        return {"kv": [Item(kv)], "tok": [Item(first)]}

    def decode(ins):
        kv_in: KVCache = ins["kv"][0].data
        kv = KVCache(name, kv_in.digest, kv_in.seq_len + 1, kv_bpt)
        return {"kv": [Item(kv)], "tok": [Item(_next_token(kv_in.digest, kv.seq_len, vocab))]}

    def detokenize(ins):
        toks = [it.data for it in ins["toks"]]
        text = ("tok:" + ",".join(str(t) for t in toks)).encode()
        return {"text": [Item(text)]}

    # typed declarations (SDK front door); registered in the legacy order
    specs = {
        "tokenize": sdk.declare(
            f"{name}_tokenize", tokenize,
            inputs=("prompt",), outputs=("tokens",), context_bytes=1 << 20,
        ),
        "prefill": sdk.declare(
            f"{name}_prefill", prefill,
            inputs=("tokens",), outputs=("kv", "tok"),
            batchable=prefill_chunk is not None,
            context_bytes=spec.prompt_len_hint * kv_bpt + (4 << 20),
        ),
        "decode": sdk.declare(
            f"{name}_decode", decode,
            inputs=("kv", "tok"), outputs=("kv", "tok"), batchable=True,
            context_bytes=spec.seq_len_hint * kv_bpt + (1 << 20),
        ),
        "detok": sdk.declare(
            f"{name}_detok", detokenize,
            inputs=("toks",), outputs=("text",), context_bytes=1 << 20,
        ),
    }
    for s in specs.values():
        s.register_into(reg)

    # ---- cost models (launch.hlo_analysis) -----------------------------
    weight_cold = weight_coldstart_estimate(
        spec.param_bytes,
        exported=exported,
        hlo_ops=spec.hlo_ops_estimate,
        disk_bandwidth_bps=disk_bandwidth_bps,
        compile_s_per_op=compile_s_per_op,
    )
    prefill_terms = serving_step_terms(
        param_bytes=spec.param_bytes,
        flops_per_seq=spec.flops_per_token * spec.prompt_len_hint,
        kv_bytes_per_seq=spec.prompt_len_hint * kv_bpt,
        batch=1, peak_flops=hw.peak_flops, hbm_bw=hw.hbm_bandwidth,
        ici_bw=hw.ici_bandwidth,
    )
    decode_terms = serving_step_terms(
        param_bytes=spec.param_bytes,
        flops_per_seq=spec.flops_per_token,
        kv_bytes_per_seq=spec.seq_len_hint * kv_bpt,
        batch=1, peak_flops=hw.peak_flops, hbm_bw=hw.hbm_bandwidth,
        ici_bw=hw.ici_bandwidth,
    )
    batch_model = BatchStepModel(
        flops_per_seq=spec.flops_per_token,
        fixed_bytes=float(spec.param_bytes),
        bytes_per_seq=float(spec.seq_len_hint * kv_bpt),
        peak_flops=hw.peak_flops,
        hbm_bw=hw.hbm_bandwidth,
        overhead_s=step_overhead_s,
    )
    prefill_s = prefill_terms.step_time_s + step_overhead_s
    decode_s = batch_model.step_s(1)
    batch_models = {f"{name}_decode": batch_model}
    if prefill_chunk is not None:
        # one *chunk* is the unit of a coalesced prefill step; a request
        # occupies ceil(prompt_len / chunk) units of that step
        batch_models[f"{name}_prefill"] = BatchStepModel(
            flops_per_seq=spec.flops_per_token * prefill_chunk,
            fixed_bytes=float(spec.param_bytes),
            bytes_per_seq=float(prefill_chunk * kv_bpt),
            peak_flops=hw.peak_flops,
            hbm_bw=hw.hbm_bandwidth,
            overhead_s=step_overhead_s,
        )

    profiles = {
        f"{name}_tokenize": ColdStartProfile(SANDBOX_SETUP_S, 0.2e-3, 0.05),
        f"{name}_prefill": ColdStartProfile(
            # chunked prefill rides the batching engine, which must be
            # able to substitute step_s(units) without RNG skew: no jitter
            SANDBOX_SETUP_S, prefill_s,
            0.0 if prefill_chunk is not None else 0.05,
            cold_setup_s=weight_cold.total_s,
        ),
        f"{name}_decode": ColdStartProfile(
            # jitter-free: the batching engine must be able to substitute
            # step_s(n) for n independent durations without RNG skew
            SANDBOX_SETUP_S, decode_s, 0.0, cold_setup_s=weight_cold.total_s,
        ),
        f"{name}_detok": ColdStartProfile(SANDBOX_SETUP_S, 0.2e-3, 0.05),
    }
    for s in specs.values():
        s.profile = profiles[s.name]
    return InferenceService(
        spec=spec,
        profiles=profiles,
        batch_model=batch_model,
        weight_cold=weight_cold,
        prefill_step_s=prefill_s,
        decode_step_s=decode_s,
        fn_names=tuple(profiles),
        specs=specs,
        batch_models=batch_models,
        prefill_chunk=prefill_chunk,
    )


def request_app(
    spec: LMSpec,
    *,
    prompt_len: int,
    n_decode: int,
    specs: Optional[Dict[str, sdk.FunctionSpec]] = None,
    prefill_chunk: Optional[int] = None,
) -> sdk.App:
    """One serving request as a declarative SDK application: the decode
    chain is unrolled to this request's token budget, each link passing
    the (growing) KV cache item and the previous token forward, every
    token also feeding detokenize. Without ``specs`` (an
    ``InferenceService.specs`` mapping), typed references to the
    registered function names are used. ``prefill_chunk`` (matching the
    service's) sizes the prefill vertex at ``ceil(prompt_len / chunk)``
    units of a coalesced BATCH step."""
    kv_bpt = spec.kv_bytes_per_token
    name = spec.name
    prefill_units = (None if prefill_chunk is None
                     else max(1, math.ceil(prompt_len / prefill_chunk)))
    if specs is None:
        specs = {
            "tokenize": sdk.ref(f"{name}_tokenize",
                                inputs=("prompt",), outputs=("tokens",)),
            "prefill": sdk.ref(f"{name}_prefill",
                               inputs=("tokens",), outputs=("kv", "tok")),
            "decode": sdk.ref(f"{name}_decode",
                              inputs=("kv", "tok"), outputs=("kv", "tok")),
            "detok": sdk.ref(f"{name}_detok",
                             inputs=("toks",), outputs=("text",)),
        }
    with sdk.composition(f"{name}_p{prompt_len}_d{n_decode}") as app:
        tok = specs["tokenize"](_name="tokenize", _context_bytes=1 << 20,
                                prompt=app.input("prompt"))
        pre = specs["prefill"](
            _name="prefill",
            _context_bytes=prompt_len * kv_bpt + (4 << 20),
            _batch_units=prefill_units,
            tokens=tok.tokens,
        )
        det = specs["detok"](_name="detokenize", _context_bytes=1 << 20)
        det.feed(toks=pre.tok)
        prev = pre
        for i in range(n_decode):
            # context sized to the cache at this step: in + out copies
            d = specs["decode"](
                _name=f"decode{i}",
                _context_bytes=2 * (prompt_len + i + 1) * kv_bpt + (1 << 20),
                kv=prev.kv, tok=prev.tok,
            )
            det.feed(toks=d.tok)
            prev = d
        app.output("text", det.text)
    return app


def build_request_composition(
    spec: LMSpec,
    *,
    prompt_len: int,
    n_decode: int,
    prefill_chunk: Optional[int] = None,
) -> Composition:
    """The request DAG as an IR ``Composition`` (see ``request_app``).
    The functions must already be registered
    (``register_inference_service``).

    Builds the IR directly — no SDK declaration objects — because serving
    traces construct thousands of distinct ``(prompt_len, n_decode)``
    shapes per run and the declarative front door dominated the
    simulator's admission cost. Field-for-field structurally identical
    to ``request_app(...).compile()``: same vertex declaration order,
    same edge append order, same bindings (pinned by
    tests/test_inference_service.py and tests/test_torch_apps.py)."""
    kv_bpt = spec.kv_bytes_per_token
    name = spec.name
    comp = Composition(f"{name}_p{prompt_len}_d{n_decode}")
    vertices = comp.vertices
    vertices["tokenize"] = Vertex(
        "tokenize", COMPUTE, f"{name}_tokenize", ("prompt",), ("tokens",),
        context_bytes=1 << 20,
    )
    vertices["prefill"] = Vertex(
        "prefill", COMPUTE, f"{name}_prefill", ("tokens",), ("kv", "tok"),
        context_bytes=prompt_len * kv_bpt + (4 << 20),
        batch_units=(1 if prefill_chunk is None
                     else max(1, math.ceil(prompt_len / prefill_chunk))),
    )
    vertices["detokenize"] = Vertex(
        "detokenize", COMPUTE, f"{name}_detok", ("toks",), ("text",),
        context_bytes=1 << 20,
    )
    edges = comp.edges
    in_adj, out_adj = comp._in_adj, comp._out_adj

    def _edge(sv: str, ss: str, dv: str, ds: str) -> None:
        e = Edge(PortRef(sv, ss), PortRef(dv, ds))
        edges.append(e)
        out_adj.setdefault(sv, []).append(e)
        in_adj.setdefault(dv, []).append(e)

    _edge("tokenize", "tokens", "prefill", "tokens")
    _edge("prefill", "tok", "detokenize", "toks")
    prev = "prefill"
    for i in range(n_decode):
        vn = f"decode{i}"
        vertices[vn] = Vertex(
            vn, COMPUTE, f"{name}_decode", ("kv", "tok"), ("kv", "tok"),
            context_bytes=2 * (prompt_len + i + 1) * kv_bpt + (1 << 20),
        )
        _edge(prev, "kv", vn, "kv")
        _edge(prev, "tok", vn, "tok")
        _edge(vn, "tok", "detokenize", "toks")
        prev = vn
    comp._adj_edges_n = len(edges)
    comp.input_bindings["prompt"] = PortRef("tokenize", "prompt")
    comp.output_bindings["text"] = PortRef("detokenize", "text")
    return comp


def expected_tokens(prompt: bytes, spec: LMSpec, n_decode: int) -> List[int]:
    """Reference token stream for a prompt — what any platform run must
    produce regardless of batching, placement, or policy (the pure-
    function contract)."""
    digest_p = hashlib.blake2b(prompt, digest_size=8).hexdigest()
    n = max(1, len(prompt) // 4)
    rng = np.random.default_rng(int(digest_p, 16) % (2**32))
    toks = rng.integers(0, spec.vocab_size, size=n, dtype=np.int32)
    digest = hashlib.blake2b(toks.tobytes(), digest_size=8).hexdigest()
    return [_next_token(digest, n + i, spec.vocab_size) for i in range(n_decode + 1)]
