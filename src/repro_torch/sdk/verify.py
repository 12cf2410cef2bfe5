"""``sdk.verify``: the SDK front door to the static-analysis subsystem.

``verify(target)`` returns a ``repro_torch.analysis.PurityReport`` for an
``App``, a ``FunctionSpec``, a raw IR ``Composition``, or a list of
those — payload purity findings (``repro_torch.analysis.purity``) merged with
graph-shape findings on the compiled composition
(``repro_torch.analysis.graphlint``). It never raises on findings: the report
carries them, ``report.ok`` says whether strict mode would pass, and
``Platform(verify="strict")`` is the enforcing caller (raising
``sdk.PurityError``).

Declarations marked ``pure_unsafe=True`` are still analyzed: their
findings are waived (reason ``pure_unsafe=True on declaration``) and the
function is listed in ``report.unsafe`` — an audited opt-out.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

from repro_torch.analysis import lint_composition, PurityReport
from repro_torch.analysis.purity import analyze_callable
from repro_torch.core.dag import COMPUTE, SUBGRAPH, Composition
from repro_torch.sdk.builder import App
from repro_torch.sdk.functions import FunctionSpec


def _spec_entries(specs: Iterable[FunctionSpec], registry
                  ) -> List[Tuple[str, object, bool]]:
    entries: List[Tuple[str, object, bool]] = []
    for spec in specs:
        if spec.is_ref:
            if registry is not None:
                cf = registry.functions.get(spec.name)
                if cf is not None:
                    entries.append((cf.name, cf.fn,
                                    getattr(cf, "pure_unsafe", False)))
            continue
        entries.append((spec.name, spec.fn, spec.pure_unsafe))
    return entries


def _comp_entries(comp: Composition, registry,
                  _seen: Optional[set] = None
                  ) -> List[Tuple[str, object, bool]]:
    """Registered payloads of a composition's compute vertices."""
    seen = _seen if _seen is not None else set()
    entries: List[Tuple[str, object, bool]] = []
    if registry is None:
        return entries
    for v in comp.vertices.values():
        if v.kind == COMPUTE and v.function not in seen:
            seen.add(v.function)
            cf = registry.functions.get(v.function)
            if cf is not None:
                entries.append((cf.name, cf.fn,
                                getattr(cf, "pure_unsafe", False)))
        elif v.kind == SUBGRAPH and v.subgraph is not None:
            entries.extend(_comp_entries(v.subgraph, registry, seen))
    return entries


def verify(target, *, registry=None, cluster: bool = False,
           crossnode: bool = False) -> PurityReport:
    """Statically verify ``target`` against the pure-function contract.

    ``registry`` resolves ``sdk.ref`` declarations and raw-IR vertex
    functions to their registered payloads; ``cluster``/``crossnode``
    give the composition lint its deployment context (the
    ``graph-fanout-local`` rule only fires on multi-node shapes without
    cross-node scheduling).
    """
    findings = []
    entries: List[Tuple[str, object, bool]] = []
    comps: List[Composition] = []

    targets = target if isinstance(target, (list, tuple)) else [target]
    for t in targets:
        if isinstance(t, FunctionSpec):
            entries.extend(_spec_entries([t], registry))
        elif isinstance(t, App):
            entries.extend(_spec_entries(t.function_specs(), registry))
            comps.append(t.compile(registry) if registry is not None
                         else t.compile())
        elif isinstance(t, Composition):
            entries.extend(_comp_entries(t, registry))
            comps.append(t)
        elif hasattr(t, "fn") and hasattr(t, "name"):   # ComputeFunction
            entries.append((t.name, t.fn,
                            getattr(t, "pure_unsafe", False)))
        else:
            raise TypeError(
                f"verify() takes an App, Composition, FunctionSpec, or a "
                f"list of those, got {type(t).__name__}"
            )

    checked: List[str] = []
    unsafe: List[str] = []
    seen_names = set()
    for name, fn, pure_unsafe in entries:
        if name in seen_names:
            continue
        seen_names.add(name)
        checked.append(name)
        got = analyze_callable(fn, name=name)
        if pure_unsafe:
            unsafe.append(name)
            got = [f if f.waived else
                   f.waive("pure_unsafe=True on declaration")
                   for f in got]
        findings.extend(got)

    for comp in comps:
        findings.extend(lint_composition(
            comp, cluster=cluster, crossnode=crossnode).findings)

    return PurityReport(findings, checked=sorted(checked),
                        unsafe=sorted(unsafe))
