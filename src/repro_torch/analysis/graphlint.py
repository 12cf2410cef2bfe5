"""Composition lint: graph-level checks on the built IR.

Where the purity verifier reads payload *source*, this pass reads the
compiled :class:`~repro_torch.core.dag.Composition` — the shape mistakes that
``validate()`` (which guards well-formedness) deliberately accepts but
that waste work or mislead at runtime:

  * ``graph-unreachable``     (warn) — a vertex no composition input can
    reach: registered, scheduled against, never fed by a request;
  * ``graph-dangling-output`` (info) — an output set consumed by no edge
    and exported by no output binding (often fine: the last decode step
    of an inference chain legitimately drops its ``kv`` set);
  * ``graph-comm-retry``      (warn) — a ``RetryPolicy`` on a COMM
    vertex: the dispatcher only honors retries when the in-flight
    payload's method is idempotent (``Dispatcher._comm_idempotent``),
    so a retry budget on a POST-carrying vertex silently does
    nothing;
  * ``graph-fanout-local``    (info) — an ``each``/``key`` fan-out on a
    multi-node deployment without ``crossnode``: every instance lands on
    the owning node (the fig12 oversubscription scenario).

Severities are chosen so the repo's own apps stay strict-clean: none of
these is provably wrong from the graph alone, so none blocks.
"""
from __future__ import annotations

from typing import List, Optional, Set

from ..core import dag
from .findings import Finding, INFO, Report, WARN


def _idempotent_methods() -> frozenset:
    try:
        from ..core.dispatcher import IDEMPOTENT_METHODS
        return frozenset(IDEMPOTENT_METHODS)
    except Exception:
        return frozenset({"GET", "HEAD", "OPTIONS", "PUT", "DELETE"})


def _reachable_from(comp: "dag.Composition", roots: Set[str]) -> Set[str]:
    seen = set(roots)
    frontier = list(roots)
    while frontier:
        v = frontier.pop()
        for e in comp.out_edges(v):
            if e.dst.vertex not in seen:
                seen.add(e.dst.vertex)
                frontier.append(e.dst.vertex)
    return seen


def lint_composition(comp: "dag.Composition", *, cluster: bool = False,
                     crossnode: bool = False,
                     _prefix: str = "") -> Report:
    """Lint one composition (recursing into SUBGRAPH vertices)."""
    findings: List[Finding] = []
    loc = f"<composition:{comp.name}>"

    def here(v: str) -> str:
        return f"{_prefix}{v}"

    # unreachable: only meaningful relative to declared inputs — in a
    # DAG every vertex is reachable from *some* zero-in-degree vertex,
    # so we ask the stronger question "can a request's inputs reach it?"
    if comp.input_bindings:
        roots = {p.vertex for p in comp.input_bindings.values()}
        reach = _reachable_from(comp, roots)
        for name in comp.vertices:
            if name not in reach:
                findings.append(Finding(
                    rule="graph-unreachable", severity=WARN, file=loc,
                    line=0, function=here(name),
                    message=f"vertex {name!r} is unreachable from the "
                            f"composition inputs "
                            f"{sorted(comp.input_bindings)}; it will "
                            f"never receive request data"))

    exported = {p for p in comp.output_bindings.values()}
    for v in comp.vertices.values():
        consumed = {e.src.set_name for e in comp.out_edges(v.name)}
        for out_set in v.outputs:
            if out_set in consumed:
                continue
            if any(p.vertex == v.name and p.set_name == out_set
                   for p in exported):
                continue
            findings.append(Finding(
                rule="graph-dangling-output", severity=INFO, file=loc,
                line=0, function=here(v.name),
                message=f"output set {out_set!r} of {v.name!r} feeds no "
                        f"edge and no output binding; its items are "
                        f"dropped on completion"))

        if (v.kind == dag.COMM and v.retry is not None
                and v.retry.max_retries > 0):
            methods = ", ".join(sorted(_idempotent_methods()))
            findings.append(Finding(
                rule="graph-comm-retry", severity=WARN, file=loc,
                line=0, function=here(v.name),
                message=f"RetryPolicy(max_retries="
                        f"{v.retry.max_retries}) on COMM vertex "
                        f"{v.name!r}: the dispatcher retries comm tasks "
                        f"only for idempotent payload methods "
                        f"({methods}); non-idempotent requests fail "
                        f"without retry regardless of this policy"))

        if v.kind == dag.SUBGRAPH and v.subgraph is not None:
            findings.extend(lint_composition(
                v.subgraph, cluster=cluster, crossnode=crossnode,
                _prefix=f"{here(v.name)}/").findings)

    if cluster and not crossnode:
        for e in comp.edges:
            if e.mode in ("each", "key"):
                findings.append(Finding(
                    rule="graph-fanout-local", severity=INFO, file=loc,
                    line=0, function=here(e.dst.vertex),
                    message=f"'{e.mode}' fan-out into "
                            f"{e.dst.vertex!r} on a multi-node "
                            f"deployment without crossnode: every "
                            f"instance is placed on the owning node "
                            f"(enable crossnode=True / CROSSNODE=1 to "
                            f"spread)"))

    return Report(findings)


def registration_lint_hook(mode: str = "warn"):
    """Build a hook for :func:`repro_torch.core.dag.add_registration_hook`.

    ``warn`` emits one ``warnings.warn`` per linted composition with
    findings; ``strict`` raises ``ValueError`` when any unwaived
    warn/error-severity finding exists. The hook runs at
    ``FunctionRegistry.register_composition`` time — before any
    dispatch touches the graph.
    """
    if mode not in ("warn", "strict"):
        raise ValueError(f"registration lint mode must be 'warn' or "
                         f"'strict', got {mode!r}")

    def hook(comp: "dag.Composition") -> None:
        report = lint_composition(comp)
        if not report.findings:
            return
        serious = [f for f in report.unwaived
                   if f.severity in (WARN, "error")]
        if mode == "strict" and serious:
            raise ValueError(
                f"composition {comp.name!r} failed registration lint:\n"
                + "\n".join(f.render() for f in serious))
        if serious:
            import warnings
            warnings.warn(
                f"composition {comp.name!r}: "
                + "; ".join(f.render() for f in serious),
                stacklevel=3)

    return hook
