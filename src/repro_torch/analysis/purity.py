"""Purity verifier: static analysis of compute-function bodies.

Dandelion executes compute functions in lightweight sandboxes *because*
they are pure — no guest OS, no ambient authority, safe to memoize and
to re-execute on retry (PAPER.md §ideas; docs/ARCHITECTURE.md). This
pass checks a declared payload against that contract before it reaches
a registry:

  * ``io``              — file/network/subprocess/stdout I/O;
  * ``wall-clock``      — host-clock reads (``time.*``, ``datetime.now``);
  * ``rng``             — unseeded / global-state RNG;
  * ``global-mutation`` — writes to module globals or closed-over state;
  * ``set-iter``        — hash-ordered iteration feeding outputs;
  * ``builtin-hash``    — per-process salted ``hash()``.

Analysis is *source-based*: ``inspect.getsourcelines`` on the payload,
names resolved against the function's live ``__globals__`` and closure
(so ``import numpy as np`` cannot dodge the rng rule), and a bounded
recursion into same-package callees (a payload that calls a helper that
calls ``print`` is as impure as one that prints directly). Payloads
whose source cannot be retrieved (C extensions, ``exec``-built code)
get an advisory ``source-unavailable`` finding — never blocking, since
strictness must not reject code the analyzer simply cannot see.

Results are memoized by code object: fig10 deploys 100 apps sharing one
lambda code object and pays for one analysis.
"""
from __future__ import annotations

import ast
import functools
import inspect
import os
import textwrap
import types
from dataclasses import replace
from typing import Dict, FrozenSet, Iterable, List, Optional, Set, Tuple

from .findings import Finding, INFO, PurityReport
from .rules import PURITY_CHECKS, RuleContext
from .walker import (Analysis, ImportTable, collect_bindings, dotted_name,
                     parent_map, parse_pragmas, set_typed_locals)

#: (code object, remaining recursion depth) -> findings
_MEMO: Dict[Tuple[types.CodeType, int], Tuple[Finding, ...]] = {}

#: how many levels of same-package callees to follow
DEFAULT_CALL_DEPTH = 2


def clear_cache() -> None:
    _MEMO.clear()


def _display_path(path: str) -> str:
    """Repo-relative when possible, for stable report text."""
    try:
        rel = os.path.relpath(path)
    except ValueError:
        return path
    return path if rel.startswith("..") else rel


def _namespace(fn: types.FunctionType) -> Dict[str, object]:
    """Live globals + closure cells, for canonical name resolution."""
    ns = dict(getattr(fn, "__globals__", {}) or {})
    code = getattr(fn, "__code__", None)
    closure = getattr(fn, "__closure__", None)
    if code is not None and closure:
        for var, cell in zip(code.co_freevars, closure):
            try:
                ns[var] = cell.cell_contents
            except ValueError:
                pass                      # empty cell
    return ns


def _locate(tree: ast.AST, fn: types.FunctionType,
            start: int) -> Optional[ast.AST]:
    """Find the def/lambda node for ``fn`` in its parsed source block."""
    name = fn.__name__
    if name != "<lambda>":
        for node in ast.walk(tree):
            if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and node.name == name):
                return node
        return None
    target = fn.__code__.co_firstlineno - start + 1
    lambdas = [n for n in ast.walk(tree) if isinstance(n, ast.Lambda)]
    exact = [n for n in lambdas if n.lineno == target]
    if exact:
        return exact[0]
    return min(lambdas, key=lambda n: abs(n.lineno - target), default=None)


def _callees(fn_node: ast.AST, fn: types.FunctionType,
             ns: Dict[str, object]) -> List[Tuple[str, types.FunctionType]]:
    """Same-package plain functions this body calls, for recursion."""
    fn_root = (getattr(fn, "__module__", "") or "").split(".")[0]
    out: List[Tuple[str, types.FunctionType]] = []
    seen: Set[types.CodeType] = set()
    for node in ast.walk(fn_node):
        if not isinstance(node, ast.Call):
            continue
        dotted = dotted_name(node.func)
        if dotted is None:
            continue
        root, _, rest = dotted.partition(".")
        obj = ns.get(root)
        if rest and isinstance(obj, types.ModuleType) and "." not in rest:
            obj = getattr(obj, rest, None)
        elif rest:
            continue
        if not isinstance(obj, types.FunctionType):
            continue
        if obj.__code__ is fn.__code__ or obj.__code__ in seen:
            continue
        callee_root = (getattr(obj, "__module__", "") or "").split(".")[0]
        if callee_root not in (fn_root, "__main__") and fn_root != "__main__":
            continue
        seen.add(obj.__code__)
        out.append((dotted, obj))
    return out


def _retag(f: Finding, canonical: str, name: str) -> Finding:
    """Re-address a memoized finding to the declared name.

    Findings are computed (and memoized) under the callable's own
    ``__name__``; a declaration site may register the same code object
    under many names (fig10 declares one lambda 100 times). Top-level
    findings get the declared name as ``function``; callee findings keep
    the callee's name but their call-chain message is rewritten.
    """
    if f.function == canonical:
        f = replace(f, function=name)
    needle = f"(called from {canonical})"
    if needle in f.message:
        f = replace(f, message=f.message.replace(
            needle, f"(called from {name})"))
    if canonical != "<lambda>" and repr(canonical) in f.message:
        f = replace(f, message=f.message.replace(
            repr(canonical), repr(name)))
    return f


def analyze_callable(fn, *, name: Optional[str] = None,
                     depth: int = DEFAULT_CALL_DEPTH,
                     _stack: Optional[FrozenSet[types.CodeType]] = None
                     ) -> List[Finding]:
    """All purity findings for one callable (and its callee chain).

    ``name`` is the *declared* name to report under (``sdk.declare``'s
    first argument); analysis itself runs under the callable's own
    ``__name__`` so the memo is shared across declarations."""
    canonical = getattr(fn, "__name__", repr(fn))
    if name is not None and name != canonical:
        return [_retag(f, canonical, name)
                for f in analyze_callable(fn, depth=depth, _stack=_stack)]
    name = canonical
    if isinstance(fn, functools.partial):
        return analyze_callable(fn.func, name=name, depth=depth,
                                _stack=_stack)
    code = getattr(fn, "__code__", None)
    if code is None or not isinstance(fn, types.FunctionType):
        return [Finding(rule="source-unavailable", severity=INFO,
                        file="<unknown>", line=0, function=name,
                        message=f"{name!r} is not a plain Python "
                                f"function; purity not analyzable")]
    stack = _stack or frozenset()
    if code in stack:
        return []                        # recursion cycle
    memo_key = (code, depth)
    if memo_key in _MEMO:
        return list(_MEMO[memo_key])

    try:
        path = inspect.getsourcefile(fn) or "<unknown>"
        lines, start = inspect.getsourcelines(fn)
        tree = ast.parse(textwrap.dedent("".join(lines)))
    except (OSError, TypeError, SyntaxError) as exc:
        findings = [Finding(
            rule="source-unavailable", severity=INFO, file="<unknown>",
            line=0, function=name,
            message=f"source for {name!r} unavailable ({exc})")]
        _MEMO[memo_key] = tuple(findings)
        return findings

    disp = _display_path(path)
    fn_node = _locate(tree, fn, start)
    if fn_node is None:
        findings = [Finding(
            rule="source-unavailable", severity=INFO, file=disp,
            line=start, function=name,
            message=f"could not locate the def/lambda for {name!r} in "
                    f"its source block")]
        _MEMO[memo_key] = tuple(findings)
        return findings

    ns = _namespace(fn)
    waivers = parse_pragmas("".join(lines).splitlines(), first_lineno=start)
    analysis = Analysis(disp, waivers=waivers, line_offset=start - 1,
                        function=name)
    imports = ImportTable.from_tree(tree, runtime=ns)
    ctx = RuleContext(
        analysis, imports, parent_map(fn_node),
        local_names=frozenset(collect_bindings(fn_node)),
        set_locals=frozenset(set_typed_locals(fn_node)))

    body = fn_node.body if isinstance(fn_node.body, list) else [fn_node.body]
    for stmt in body:
        for node in ast.walk(stmt):
            for check in PURITY_CHECKS:
                check(node, ctx)
    findings = analysis.findings()

    if depth > 0:
        for dotted, callee in _callees(fn_node, fn, ns):
            for f in analyze_callable(callee, name=callee.__name__,
                                      depth=depth - 1,
                                      _stack=stack | {code}):
                findings.append(replace(
                    f, message=f"in callee {dotted}() "
                               f"(called from {name}): {f.message}"))

    _MEMO[memo_key] = tuple(findings)
    return findings


def verify_functions(entries: Iterable[Tuple[str, object, bool]]
                     ) -> PurityReport:
    """Build a :class:`PurityReport` for ``(name, fn, pure_unsafe)``
    declarations. ``pure_unsafe=True`` waives every finding of that
    function (recorded in the report's ``unsafe`` list)."""
    findings: List[Finding] = []
    checked: List[str] = []
    unsafe: List[str] = []
    for name, fn, pure_unsafe in entries:
        checked.append(name)
        got = analyze_callable(fn, name=name)
        if pure_unsafe:
            unsafe.append(name)
            got = [f if f.waived else
                   f.waive("pure_unsafe=True on declaration")
                   for f in got]
        findings.extend(got)
    return PurityReport(findings, checked=sorted(set(checked)),
                        unsafe=sorted(set(unsafe)))
