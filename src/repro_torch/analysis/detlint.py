"""Determinism lint: the byte-identity rules over simulator sources.

The fig10–15 benchmark outputs are pinned byte-for-byte by
``tools/check_bench_identity.py`` — CSVs must not drift across runs,
processes, or knob settings. That invariant dies quietly when modeled
code reads the host clock, draws from a global RNG, orders by ``id()``,
or iterates a set into a journal/heap/timeline. This pass runs the
shared determinism rules (:data:`repro_torch.analysis.rules.DETERMINISM_CHECKS`)
over whole modules under ``src/repro_torch/`` so those hazards fail CI at
commit time instead of surfacing as benchmark diffs later.

Legitimately-real paths (real-exec engine timing, cold-start
measurement, calibration capture, CLI launchers) carry waiver pragmas
whose ``reason=`` names the contract:

    t0 = time.perf_counter()  # det-lint: waive[wall-clock] reason=real-exec path, not modeled

Scope handling mirrors Python's: each ``def``/``lambda`` is analyzed in
its own scope (so set-typed locals don't leak between functions), with
module-level set-typed names visible to all scopes.

CLI: ``python -m repro_torch.analysis.detlint [paths...]`` — exits
nonzero on any unwaived finding.
"""
from __future__ import annotations

import argparse
import ast
import os
import sys
from pathlib import Path
from typing import Iterable, Iterator, List, Tuple

from .findings import Finding, Report
from .rules import DETERMINISM_CHECKS, RuleContext
from .walker import (Analysis, ImportTable, collect_bindings, is_set_expr,
                     parent_map, parse_pragmas)

_SCOPE_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _scope_body(scope: ast.AST) -> List[ast.AST]:
    if isinstance(scope, ast.Lambda):
        return [scope.body]
    return list(scope.body)        # Module / FunctionDef


def _scope_walk(scope: ast.AST) -> Iterator[ast.AST]:
    """Nodes belonging to ``scope``, not descending into nested defs."""
    stack = _scope_body(scope)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, _SCOPE_NODES):
            continue                 # nested scope: analyzed separately
        stack.extend(ast.iter_child_nodes(node))


def _direct_set_locals(scope: ast.AST) -> set:
    """Names assigned a set expression *in this scope only*."""
    out = set()
    for node in _scope_walk(scope):
        if isinstance(node, ast.Assign) and is_set_expr(node.value):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
        elif (isinstance(node, ast.AnnAssign) and node.value is not None
              and is_set_expr(node.value)
              and isinstance(node.target, ast.Name)):
            out.add(node.target.id)
    return out


def _scopes(tree: ast.Module) -> Iterator[Tuple[str, ast.AST]]:
    """(qualified name, scope node) for the module and every def,
    recursing manually so nested names compose left-to-right."""
    yield "", tree
    stack: List[Tuple[str, ast.AST]] = [("", tree)]
    while stack:
        prefix, scope = stack.pop()
        body = _scope_body(scope)
        inner: List[ast.AST] = list(body)
        while inner:
            node = inner.pop()
            if isinstance(node, _SCOPE_NODES):
                name = getattr(node, "name", "<lambda>")
                qual = f"{prefix}.{name}" if prefix else name
                yield qual, node
                stack.append((qual, node))
            else:
                inner.extend(ast.iter_child_nodes(node))


def lint_source(text: str, display_path: str) -> List[Finding]:
    try:
        tree = ast.parse(text)
    except SyntaxError as exc:
        return [Finding(rule="source-unavailable", severity="info",
                        file=display_path, line=exc.lineno or 0,
                        message=f"not parseable: {exc.msg}")]
    waivers = parse_pragmas(text.splitlines())
    analysis = Analysis(display_path, waivers=waivers)
    imports = ImportTable.from_tree(tree)
    parents = parent_map(tree)
    module_sets = _direct_set_locals(tree)

    for qual, scope in _scopes(tree):
        analysis.function = qual
        set_locals = module_sets | _direct_set_locals(scope)
        ctx = RuleContext(
            analysis, imports, parents,
            local_names=frozenset(collect_bindings(scope))
            if qual else frozenset(),
            set_locals=frozenset(set_locals))
        for node in _scope_walk(scope):
            for check in DETERMINISM_CHECKS:
                check(node, ctx)
    return analysis.findings()


def _display(path: Path) -> str:
    try:
        rel = os.path.relpath(path)
    except ValueError:
        return str(path)
    return str(path) if rel.startswith("..") else rel


def iter_py_files(paths: Iterable[Path]) -> Iterator[Path]:
    for p in paths:
        p = Path(p)
        if p.is_dir():
            yield from sorted(q for q in p.rglob("*.py")
                              if "__pycache__" not in q.parts)
        elif p.suffix == ".py":
            yield p


def lint_paths(paths: Iterable[Path]) -> Report:
    findings: List[Finding] = []
    for path in iter_py_files(paths):
        findings.extend(lint_source(path.read_text(), _display(path)))
    return Report(findings)


def main(argv: List[str] = None) -> int:
    default_root = Path(__file__).resolve().parents[1]   # src/repro_torch
    ap = argparse.ArgumentParser(
        prog="det_lint",
        description="byte-identity determinism lint over simulator sources")
    ap.add_argument("paths", nargs="*", type=Path, default=[default_root],
                    help=f"files/dirs to lint (default: {default_root})")
    ap.add_argument("--show-waived", action="store_true",
                    help="include waived findings in the listing")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="print nothing on success")
    ns = ap.parse_args(argv)

    report = lint_paths(ns.paths or [default_root])
    unwaived = report.unwaived
    if unwaived or not ns.quiet:
        print(report.render(show_waived=ns.show_waived), file=sys.stdout)
    return 1 if unwaived else 0


if __name__ == "__main__":
    raise SystemExit(main())
