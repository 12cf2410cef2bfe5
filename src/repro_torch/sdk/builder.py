"""Declarative composition builder: port-level dataflow expressions.

Applications are authored as dataflow over typed function declarations
(the paper's SS4.1 composition language, made first-class):

    @sdk.function(inputs=("doc",), outputs=("stats",))
    def word_count(ins): ...

    with sdk.composition("quickstart") as app:
        fetch = sdk.http("fetch", requests=app.input("request"))
        count = word_count(_name="count", doc=fetch.responses)
        app.output("stats", count.stats)

and compile (``App.compile()``) to the existing ``core/dag.py``
``Composition`` IR *unchanged* — the engine layers below never see the
SDK. Building is eager: every wiring call validates immediately and
raises a ``WiringError`` naming the offending vertex/port, so a typo
fails at its own line, not at invoke time.

Fan-out sugar: wrap a producer port in ``sdk.each(...)`` / ``sdk.key(...)``
to set the edge's distribution keyword (one consumer instance per item /
per distinct item key); at most one such edge may target a vertex —
checked at the wiring call. Plain ports broadcast (``all``).

Multi-feed inputs: pass a list of ports (``toks=[pre.tok, d.tok]``) or
feed an existing vertex handle incrementally (``det.feed(toks=d.tok)``).

Nesting: a finished ``App`` is itself callable inside another builder
and becomes a subgraph vertex whose ports are the inner composition's
input/output bindings.

Vertices are added to the IR in declaration order and edges in wiring
order, so an SDK build can reproduce a hand-built ``Composition``
byte-for-byte (pinned by tests/test_sdk.py) — which is what keeps the
migrated benchmarks' CSV rows identical.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.core.dag import Composition, PortRef, RetryPolicy
from repro_torch.sdk.errors import (
    DeclarationError,
    UnknownPortError,
    ValidationError,
    WiringError,
)
from repro_torch.sdk.functions import DEFAULT_CONTEXT_BYTES, FunctionSpec

# stack of App builders entered via ``with``; FunctionSpec.__call__ and
# module-level http()/input() resolve against the innermost one
_STACK: List["App"] = []


def current_app() -> "App":
    if not _STACK:
        raise WiringError(
            "no active composition: declare vertices inside "
            "`with sdk.composition(name) as app:`"
        )
    return _STACK[-1]


# ---------------------------------------------------------------- ports
@dataclass(frozen=True)
class Port:
    """A reference to one output set of a built vertex, optionally
    carrying a fan-out mode (``each``/``key`` sugar)."""

    handle: "VertexHandle"
    set_name: str
    mode: str = "all"

    def __repr__(self):
        tag = f", mode={self.mode!r}" if self.mode != "all" else ""
        return f"Port({self.handle.name}[{self.set_name!r}]{tag})"


@dataclass(frozen=True)
class InputRef:
    """A composition-level input placeholder (``app.input(name)``)."""

    app: "App"
    name: str


def _remode(port: Port, mode: str) -> Port:
    if not isinstance(port, Port):
        raise WiringError(
            f"sdk.{mode}() expects a vertex output port, "
            f"got {type(port).__name__}"
        )
    if port.mode != "all":
        raise WiringError(
            f"{port.handle.name}[{port.set_name!r}]: fan-out mode already "
            f"set to {port.mode!r}; each()/key() cannot be combined"
        )
    return Port(port.handle, port.set_name, mode)


def each(port: Port) -> Port:
    """One consumer instance per item of this output set."""
    return _remode(port, "each")


def key(port: Port) -> Port:
    """One consumer instance per distinct item key of this output set."""
    return _remode(port, "key")


# handle attributes that attribute-style port access would shadow; an
# output set with one of these names must be renamed (eager error below)
_RESERVED_HANDLE_ATTRS = frozenset({"name", "inputs", "outputs", "feed"})


class VertexHandle:
    """Handle to a built vertex: attribute/index access yields output
    ports (``fetch.responses`` / ``fetch["responses"]``), ``feed()``
    wires additional in-edges after creation."""

    def __init__(self, app: "App", name: str, inputs: Tuple[str, ...],
                 outputs: Tuple[str, ...]):
        shadowed = sorted(set(outputs) & _RESERVED_HANDLE_ATTRS)
        if shadowed:
            raise WiringError(
                f"{name}: output set name(s) {shadowed} collide with "
                f"VertexHandle attributes (attribute access would shadow "
                f"the port); rename the set(s)"
            )
        self._app = app
        self.name = name
        self.inputs = tuple(inputs)
        self.outputs = tuple(outputs)

    def __getitem__(self, set_name: str) -> Port:
        if set_name in self.outputs:
            return Port(self, set_name)
        raise UnknownPortError(
            f"{self.name}: no output set {set_name!r}; "
            f"declared outputs: {list(self.outputs)}"
        )

    def __getattr__(self, set_name: str) -> Port:
        # only reached for names not set in __init__; reserved python
        # attributes stay errors, everything else resolves as a port
        if set_name.startswith("_"):
            raise AttributeError(set_name)
        return self[set_name]

    def feed(self, **ports) -> "VertexHandle":
        """Wire additional inputs (multi-feed input sets, forward edges
        declared before their producers)."""
        self._app._wire(self, ports)
        return self

    def __repr__(self):
        return f"VertexHandle({self.name!r} in {self._app.name!r})"


# ------------------------------------------------------------------ app
class App:
    """A composition under construction (and, once built, a reusable
    application: deployable, invokable, nestable as a subgraph)."""

    def __init__(self, name: str):
        if not isinstance(name, str) or not name:
            raise DeclarationError(
                f"composition name must be a non-empty string, got {name!r}"
            )
        self.name = name
        self.comp = Composition(name)
        # function declarations used by this app (insertion-ordered),
        # keyed by function name — what Platform.deploy registers
        self._specs: Dict[str, FunctionSpec] = {}
        self._fan_in: Dict[str, str] = {}   # vertex -> each/key mode used
        self._validated = False

    # ------------------------------------------------------- build scope
    def __enter__(self) -> "App":
        _STACK.append(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        popped = _STACK.pop()
        assert popped is self, "composition builder stack corrupted"
        return False

    # ------------------------------------------------------------ inputs
    def input(self, name: str) -> InputRef:
        """A composition-level input, fed at ``Platform.invoke``; pass it
        as a port argument to exactly one vertex input set."""
        if not isinstance(name, str) or not name:
            raise WiringError(
                f"{self.name}: input name must be a non-empty string, "
                f"got {name!r}"
            )
        return InputRef(self, name)

    def output(self, name: str, port: Port) -> None:
        """Bind a composition-level output to a vertex output port."""
        if not isinstance(port, Port):
            raise WiringError(
                f"{self.name}: output {name!r} must bind a vertex output "
                f"port, got {type(port).__name__}"
            )
        if port.mode != "all":
            raise WiringError(
                f"{self.name}: output {name!r}: each()/key() apply to "
                f"vertex inputs, not composition outputs"
            )
        if port.handle._app is not self:
            raise WiringError(
                f"{self.name}: output {name!r} binds "
                f"{port.handle.name}[{port.set_name!r}] from composition "
                f"{port.handle._app.name!r}"
            )
        if name in self.comp.output_bindings:
            raise WiringError(f"{self.name}: duplicate output {name!r}")
        self.comp.bind_output(name, PortRef(port.handle.name, port.set_name))
        self._validated = False

    # ---------------------------------------------------------- vertices
    def _new_vertex_name(self, vname: str) -> str:
        if vname in self.comp.vertices:
            raise WiringError(
                f"{self.name}: duplicate vertex {vname!r} "
                f"(pass _name=... to disambiguate)"
            )
        return vname

    def _adopt_spec(self, spec: FunctionSpec) -> None:
        known = self._specs.get(spec.name)
        if known is not None and known is not spec:
            raise WiringError(
                f"{self.name}: two different declarations both named "
                f"{spec.name!r} used in one composition"
            )
        self._specs[spec.name] = spec

    def _add_compute(self, spec: FunctionSpec, *, name: Optional[str],
                     context_bytes: Optional[int], timeout_s: Optional[float],
                     ports: dict,
                     retry: Optional[RetryPolicy] = None,
                     batch_units: Optional[int] = None) -> VertexHandle:
        vname = self._new_vertex_name(name or spec.name)
        self._adopt_spec(spec)
        self.comp.compute(
            vname, spec.name, inputs=spec.inputs, outputs=spec.outputs,
            context_bytes=spec.context_bytes if context_bytes is None
            else context_bytes,
            timeout_s=spec.timeout_s if timeout_s is None else timeout_s,
            retry=spec.retry if retry is None else retry,
        )
        if batch_units is not None:
            if batch_units < 1:
                raise WiringError(
                    f"{vname}: _batch_units must be >= 1, got {batch_units}")
            self.comp.vertices[vname].batch_units = batch_units
        handle = VertexHandle(self, vname, spec.inputs, spec.outputs)
        self._wire(handle, ports)
        self._validated = False
        return handle

    def http(self, name: str, requests=None, *,
             context_bytes: int = DEFAULT_CONTEXT_BYTES) -> VertexHandle:
        """The platform HTTP communication function (trusted, SS6.3):
        input set ``requests``, output set ``responses``."""
        vname = self._new_vertex_name(name)
        self.comp.http(vname, context_bytes=context_bytes)
        handle = VertexHandle(self, vname, ("requests",), ("responses",))
        if requests is not None:
            self._wire(handle, {"requests": requests})
        self._validated = False
        return handle

    def _add_subgraph(self, sub: "App", name: Optional[str],
                      ports: dict) -> VertexHandle:
        sub_comp = sub.compile()
        vname = self._new_vertex_name(name or sub.name)
        for spec in sub._specs.values():
            self._adopt_spec(spec)
        self.comp.subgraph(vname, sub_comp)
        handle = VertexHandle(
            self, vname,
            tuple(sub_comp.input_bindings), tuple(sub_comp.output_bindings),
        )
        self._wire(handle, ports)
        self._validated = False
        return handle

    def __call__(self, _name: Optional[str] = None, **ports) -> VertexHandle:
        """Use this (finished) app as a nested composition vertex inside
        the currently building one."""
        outer = current_app()
        if outer is self:
            raise WiringError(f"{self.name}: a composition cannot nest itself")
        return outer._add_subgraph(self, _name, ports)

    # ------------------------------------------------------------ wiring
    def _wire(self, handle: VertexHandle, ports: dict) -> None:
        for set_name, value in ports.items():
            sources = value if isinstance(value, (list, tuple)) else (value,)
            for src in sources:
                self._wire_one(handle, set_name, src)

    def _wire_one(self, handle: VertexHandle, set_name: str, src) -> None:
        if set_name not in handle.inputs:
            raise WiringError(
                f"{handle.name}: no input set {set_name!r}; "
                f"declared inputs: {list(handle.inputs)}"
            )
        if isinstance(src, InputRef):
            if src.app is not self:
                raise WiringError(
                    f"{handle.name}: input ref {src.name!r} belongs to "
                    f"composition {src.app.name!r}, not {self.name!r}"
                )
            bound = self.comp.input_bindings.get(src.name)
            if bound is not None:
                raise WiringError(
                    f"{self.name}: input {src.name!r} already feeds "
                    f"{bound.vertex}[{bound.set_name!r}]; a composition "
                    f"input feeds exactly one port"
                )
            self.comp.bind_input(src.name, PortRef(handle.name, set_name))
        elif isinstance(src, Port):
            if src.handle._app is not self:
                raise WiringError(
                    f"{handle.name}: port {src.handle.name}"
                    f"[{src.set_name!r}] belongs to composition "
                    f"{src.handle._app.name!r}, not {self.name!r}"
                )
            if src.mode in ("each", "key"):
                prev = self._fan_in.get(handle.name)
                if prev is not None:
                    raise WiringError(
                        f"{handle.name}: at most one 'each'/'key' edge may "
                        f"target a vertex (already has a {prev!r} edge)"
                    )
                self._fan_in[handle.name] = src.mode
            self.comp.edge(
                PortRef(src.handle.name, src.set_name),
                PortRef(handle.name, set_name),
                src.mode,
            )
        else:
            raise WiringError(
                f"{handle.name}.{set_name}: expected a vertex output port "
                f"or app.input(...), got {type(src).__name__}"
            )
        self._validated = False

    # ----------------------------------------------------------- compile
    def compile(self, registry=None) -> Composition:
        """Validate and return the underlying IR ``Composition`` (cached;
        the same object every call, so compiled apps are cheap to invoke
        repeatedly). With ``registry``, also checks every compute vertex
        resolves against it or this app's own declarations."""
        if not self._validated:
            try:
                self.comp.validate()
            except ValueError as e:
                raise ValidationError(str(e)) from e
            self._validated = True
        if registry is not None:
            self._check_registry(self.comp, registry)
        return self.comp

    def _check_registry(self, comp: Composition, registry) -> None:
        from repro_torch.core.dag import COMPUTE, SUBGRAPH

        for v in comp.vertices.values():
            if v.kind == COMPUTE and v.function not in registry.functions \
                    and v.function not in self._specs:
                raise ValidationError(
                    f"{comp.name}: compute vertex {v.name!r} references "
                    f"unknown function {v.function!r} (not registered, not "
                    f"declared in this composition)"
                )
            if v.kind == SUBGRAPH and v.subgraph is not None:
                self._check_registry(v.subgraph, registry)

    def function_specs(self) -> Tuple[FunctionSpec, ...]:
        """Declarations used by this app, in first-use order."""
        return tuple(self._specs.values())


def composition(name: str) -> App:
    """Start a declarative composition: ``with sdk.composition(n) as app``."""
    return App(name)


def http(name: str, requests=None, *,
         context_bytes: int = DEFAULT_CONTEXT_BYTES) -> VertexHandle:
    """Add an HTTP communication vertex to the current composition."""
    return current_app().http(name, requests, context_bytes=context_bytes)


def single_function_app(spec: FunctionSpec) -> App:
    """The one-vertex wrapper benchmarks drive single functions through:
    composition ``single_<fn>``, input/output bound straight to the
    function's (single) declared sets."""
    if len(spec.inputs) != 1 or len(spec.outputs) != 1:
        raise DeclarationError(
            f"{spec.name}: single_function_app needs exactly one input and "
            f"one output set, got {spec.inputs} -> {spec.outputs}"
        )
    with composition(f"single_{spec.name}") as app:
        v = spec(**{spec.inputs[0]: app.input(spec.inputs[0])})
        app.output(spec.outputs[0], v[spec.outputs[0]])
    return app
