"""Typed function declaration: the ``@sdk.function`` decorator.

A ``FunctionSpec`` captures *all* ``ComputeFunction`` metadata at the
definition site — declared input/output sets, context bytes, timeout,
the optional torch payload, modeled service time, memoization and
batchability flags, and an optional calibrated ``ColdStartProfile`` —
so registries, compositions, and platforms are configured from one
declaration instead of hand-wired per call site.

Counterpart of ``repro.sdk.functions``; ``torch_fn`` and ``example_args``
stand where the reference has ``jax_fn`` and ``abstract_args``, as in
``repro_torch.core.registry``.

Three ways to make one:

  * ``@sdk.function(inputs=("doc",), outputs=("stats",))`` — decorate a
    pure python payload ``fn(inputs: SetDict) -> SetDict``; the spec
    name defaults to the function name;
  * ``sdk.declare(name, fn, inputs=..., outputs=...)`` — programmatic
    form for dynamically generated payloads (benchmark sweeps);
  * ``sdk.ref(name, inputs=..., outputs=...)`` — a *reference* to a
    function registered elsewhere (no payload); compositions may wire
    it, and deployment checks it resolves.

A spec is used two ways:

  * called with port expressions inside ``with sdk.composition(...)``
    it adds a compute vertex and returns its handle
    (``count(doc=fetch.responses)``);
  * called with a plain ``SetDict`` it executes the payload directly
    (handy in tests).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Tuple

from repro_torch.core.coldstart import ColdStartProfile
from repro_torch.core.dag import RetryPolicy
from repro_torch.core.items import SetDict
from repro_torch.sdk.errors import DeclarationError, WiringError

DEFAULT_CONTEXT_BYTES = 1 << 20
DEFAULT_TIMEOUT_S = 60.0


def _retry_from_sugar(
    name: str,
    retry: Optional[RetryPolicy],
    retries: Optional[int],
    backoff_s: float,
    max_backoff_s: float,
    retry_timeouts: bool,
) -> Optional[RetryPolicy]:
    """Fold the ``retries=``/``backoff_s=``/``retry_timeouts=`` sugar into
    a ``RetryPolicy`` (None when nothing was asked for: the platform /
    dispatcher default applies)."""
    if retry is not None:
        if retries is not None or backoff_s or retry_timeouts:
            raise DeclarationError(
                f"{name}: pass retry= OR the retries=/backoff_s=/"
                f"retry_timeouts= sugar, not both"
            )
        return retry
    if retries is None and not backoff_s and not retry_timeouts:
        return None
    try:
        return RetryPolicy(
            max_retries=2 if retries is None else retries,
            base_backoff_s=backoff_s,
            max_backoff_s=max_backoff_s,
            retry_timeouts=retry_timeouts,
        )
    except ValueError as e:
        raise DeclarationError(f"{name}: {e}") from e


def _check_sets(name: str, role: str, sets) -> Tuple[str, ...]:
    if isinstance(sets, str):
        # tuple("doc") would silently split into per-character set names
        raise DeclarationError(
            f"{name}: {role}s must be a tuple of set names, got the "
            f"string {sets!r} (did you mean ({sets!r},)?)"
        )
    sets = tuple(sets)
    for s in sets:
        if not isinstance(s, str) or not s:
            raise DeclarationError(
                f"{name}: {role} set names must be non-empty strings, got {s!r}"
            )
    if len(set(sets)) != len(sets):
        raise DeclarationError(f"{name}: duplicate {role} set names in {sets}")
    return sets


@dataclass
class FunctionSpec:
    """One compute-function declaration (see module docstring)."""

    name: str
    fn: Optional[Callable[[SetDict], SetDict]]
    inputs: Tuple[str, ...]
    outputs: Tuple[str, ...]
    context_bytes: int = DEFAULT_CONTEXT_BYTES
    timeout_s: float = DEFAULT_TIMEOUT_S
    # optional torch payload for the AOT cold-start backends: a function
    # of tensors or an nn.Module, and example tensors of its inputs
    torch_fn: Optional[Callable] = None
    example_args: Tuple[Any, ...] = ()
    # modeled execution time; None -> execute for real and measure
    service_time_s: Optional[float] = None
    memoize: bool = True
    batchable: bool = False
    # calibrated dispatcher profile; Platform.deploy collects these
    profile: Optional[ColdStartProfile] = None
    # per-vertex failure handling; None -> platform/dispatcher default
    retry: Optional[RetryPolicy] = None
    # purity escape hatch: the payload is knowingly impure (stateful
    # batcher, real checkpoint I/O). Verification still runs but its
    # findings are waived and the declaration is recorded in the
    # PurityReport's ``unsafe`` list — an audited opt-out, not a blind
    # spot.
    pure_unsafe: bool = False

    def __post_init__(self):
        if not isinstance(self.name, str) or not self.name:
            raise DeclarationError(
                f"function name must be a non-empty string, got {self.name!r}"
            )
        self.inputs = _check_sets(self.name, "input", self.inputs)
        self.outputs = _check_sets(self.name, "output", self.outputs)
        if self.context_bytes <= 0:
            raise DeclarationError(
                f"{self.name}: context_bytes must be positive, "
                f"got {self.context_bytes}"
            )
        if self.timeout_s <= 0:
            raise DeclarationError(
                f"{self.name}: timeout_s must be positive, got {self.timeout_s}"
            )

    # ------------------------------------------------------------------
    @property
    def is_ref(self) -> bool:
        """True for ``sdk.ref`` specs: no payload, registered elsewhere."""
        return self.fn is None

    def register_into(self, registry):
        """Register the payload into a ``FunctionRegistry`` (the exact
        ``register_function`` call hand-wired code makes)."""
        if self.is_ref:
            raise DeclarationError(
                f"{self.name}: sdk.ref declarations carry no payload to "
                f"register; register the real function (or use sdk.declare)"
            )
        return registry.register_function(
            self.name,
            self.fn,
            context_bytes=self.context_bytes,
            torch_fn=self.torch_fn,
            example_args=self.example_args,
            service_time_s=self.service_time_s,
            memoize=self.memoize,
            batchable=self.batchable,
            pure_unsafe=self.pure_unsafe,
        )

    # ------------------------------------------------------------------
    def __call__(self, *args, _name: Optional[str] = None,
                 _context_bytes: Optional[int] = None,
                 _timeout_s: Optional[float] = None,
                 _retry: Optional[RetryPolicy] = None,
                 _batch_units: Optional[int] = None, **ports):
        """Inside ``with sdk.composition(...)``: add a compute vertex fed
        by ``ports`` (output ports / ``app.input`` refs / ``each``/``key``
        wrappers) and return its handle. ``_name`` overrides the vertex
        name (default: the function name); ``_context_bytes``,
        ``_timeout_s``, and ``_retry`` override the declared per-vertex
        resources / failure policy; ``_batch_units`` declares how many
        units of a coalesced BATCH step this vertex occupies when the
        function is batchable (chunked prefill spans several).

        Called with a single ``SetDict`` positional argument instead, the
        payload executes directly (no platform involved).
        """
        if args:
            if len(args) == 1 and isinstance(args[0], dict) and not ports:
                if self.is_ref:
                    raise DeclarationError(
                        f"{self.name}: reference spec has no payload to run"
                    )
                return self.fn(args[0])
            raise WiringError(
                f"{self.name}: pass ports as keyword arguments "
                f"(e.g. {self.name}({self.inputs[0] if self.inputs else 'x'}"
                f"=other.out)) or a single SetDict to execute the payload"
            )
        from repro_torch.sdk.builder import current_app

        app = current_app()
        return app._add_compute(
            self, name=_name, context_bytes=_context_bytes,
            timeout_s=_timeout_s, retry=_retry, ports=ports,
            batch_units=_batch_units,
        )


def function(
    inputs: Tuple[str, ...],
    outputs: Tuple[str, ...],
    *,
    name: Optional[str] = None,
    context_bytes: int = DEFAULT_CONTEXT_BYTES,
    timeout_s: float = DEFAULT_TIMEOUT_S,
    torch_fn: Optional[Callable] = None,
    example_args: Tuple[Any, ...] = (),
    service_time_s: Optional[float] = None,
    memoize: bool = True,
    batchable: bool = False,
    profile: Optional[ColdStartProfile] = None,
    retry: Optional[RetryPolicy] = None,
    retries: Optional[int] = None,      # sugar: RetryPolicy.max_retries
    backoff_s: float = 0.0,             # sugar: capped exponential base
    max_backoff_s: float = 30.0,        # sugar: backoff cap
    retry_timeouts: bool = False,       # sugar: timeouts retryable too
    pure_unsafe: bool = False,          # audited purity opt-out
) -> Callable[[Callable[[SetDict], SetDict]], FunctionSpec]:
    """Decorator form: ``@sdk.function(inputs=..., outputs=...)``.

    Failure handling: pass a full ``sdk.RetryPolicy`` via ``retry=``, or
    the ``retries=``/``backoff_s=``/``retry_timeouts=`` sugar (e.g.
    ``@sdk.function(..., retries=3, backoff_s=0.05, retry_timeouts=True)``
    for 3 resubmissions at 50/100/200ms capped backoff, rescuing
    timeouts). Omit all of them to inherit the platform default."""

    def wrap(fn: Callable[[SetDict], SetDict]) -> FunctionSpec:
        # inputs/outputs validated (incl. the bare-string typo) by
        # FunctionSpec.__post_init__
        return FunctionSpec(
            name=name or fn.__name__, fn=fn,
            inputs=inputs, outputs=outputs,
            context_bytes=context_bytes, timeout_s=timeout_s,
            torch_fn=torch_fn, example_args=tuple(example_args),
            service_time_s=service_time_s, memoize=memoize,
            batchable=batchable, profile=profile,
            retry=_retry_from_sugar(
                name or fn.__name__, retry, retries, backoff_s,
                max_backoff_s, retry_timeouts,
            ),
            pure_unsafe=pure_unsafe,
        )

    return wrap


def declare(
    name: str,
    fn: Callable[[SetDict], SetDict],
    *,
    inputs: Tuple[str, ...],
    outputs: Tuple[str, ...],
    retries: Optional[int] = None,
    backoff_s: float = 0.0,
    max_backoff_s: float = 30.0,
    retry_timeouts: bool = False,
    **kwargs,
) -> FunctionSpec:
    """Programmatic form of ``@sdk.function`` for generated payloads.
    Accepts the same retry sugar (or a full ``retry=RetryPolicy``)."""
    kwargs["retry"] = _retry_from_sugar(
        name, kwargs.get("retry"), retries, backoff_s, max_backoff_s,
        retry_timeouts,
    )
    return FunctionSpec(name=name, fn=fn, inputs=inputs,
                        outputs=outputs, **kwargs)


def ref(
    name: str,
    *,
    inputs: Tuple[str, ...],
    outputs: Tuple[str, ...],
    context_bytes: int = DEFAULT_CONTEXT_BYTES,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> FunctionSpec:
    """A typed reference to a function registered elsewhere (e.g. straight
    into the platform's ``FunctionRegistry``): usable in compositions,
    checked to resolve at deployment."""
    return FunctionSpec(name=name, fn=None, inputs=inputs,
                        outputs=outputs, context_bytes=context_bytes,
                        timeout_s=timeout_s)
