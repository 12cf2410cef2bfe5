"""SDK error taxonomy.

Every SDK error derives from ``SDKError`` (a ``ValueError``), split by
the phase that raised it — the taxonomy ``docs/API.md`` documents:

  * ``DeclarationError`` — a bad ``@sdk.function`` / ``sdk.declare`` /
    ``sdk.ref`` declaration (empty set names, duplicate ports, missing
    payload);
  * ``WiringError``      — a bad dataflow expression while building a
    composition (unknown port, duplicate vertex, double ``each``/``key``
    fan-in, cross-composition port, no active builder). Raised *eagerly*
    at the offending call, naming the culprit vertex/port;
  * ``ValidationError``  — whole-graph validation at ``App.compile()``
    (cycle, unfed input set, dangling output binding). Wraps the IR's
    ``Composition.validate`` errors, which name the culprit vertex;
  * ``DeploymentError``  — registration-time failures in
    ``Platform.deploy`` (conflicting redeclaration of a function name,
    composition referencing an unregistered function);
  * ``InvocationFailed`` — ``InvocationHandle.result()`` on a failed (or
    never-completing) invocation; carries the dispatcher's failure
    reason, which names the failing vertex;
  * ``PurityError``      — strict-mode purity verification failed at
    ``Platform(verify="strict")`` deploy time (or ``sdk.verify`` result
    escalated by the caller). Carries the full ``PurityReport`` as
    ``.report``; the message names every offending function, rule, and
    line.
"""
from __future__ import annotations


class SDKError(ValueError):
    """Base class for all declarative-SDK errors."""


class DeclarationError(SDKError):
    """Invalid function declaration (decorator / declare / ref)."""


class WiringError(SDKError):
    """Invalid dataflow expression while building a composition."""


class UnknownPortError(WiringError, AttributeError):
    """Unknown output set on a vertex handle. Also an ``AttributeError``
    so attribute-protocol probes (``hasattr``/``getattr`` with default)
    behave normally on ``VertexHandle``."""


class ValidationError(SDKError):
    """Whole-graph validation failed at compile time."""


class DeploymentError(SDKError):
    """Registration onto a Platform / FunctionRegistry failed."""


class InvocationFailed(SDKError):
    """``InvocationHandle.result()`` on a failed invocation."""


class PurityError(SDKError):
    """Strict purity verification rejected a deployment.

    ``.report`` is the full ``repro_torch.analysis.PurityReport``; the message
    lists each blocking finding as ``function @ file:line [rule]``.
    """

    def __init__(self, report):
        self.report = report
        blocking = report.blocking
        lines = [
            f"  {f.function or '<?>'} @ {f.file}:{f.line} "
            f"[{f.rule}] {f.message}"
            for f in blocking
        ]
        super().__init__(
            f"strict purity verification failed: {len(blocking)} "
            f"violation(s)\n" + "\n".join(lines)
        )
