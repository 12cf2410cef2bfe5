"""Shared AST-walker core for all three analysis passes.

The purity verifier, the determinism lint, and (indirectly) the
composition lint all sit on the helpers here:

  * ``parse_pragmas``    — the waiver-pragma grammar
                           (``# det-lint: waive[rule,...] reason=...``);
  * ``ImportTable``      — canonicalizes local names against the file's
                           imports (``np`` -> ``numpy``, ``perf_counter``
                           -> ``time.perf_counter``), with an optional
                           runtime resolver (``fn.__globals__``) layered
                           on top for payload analysis;
  * ``dotted_name``      — collapses ``Attribute`` chains to a dotted
                           string rooted at a ``Name``;
  * ``parent_map``       — child -> parent links so rules can ask "is
                           this comprehension feeding ``sum``/``sorted``?";
  * ``collect_bindings`` — names bound inside a function body (params,
                           assignments, loops, comprehensions, walrus),
                           used to separate locals from closed-over or
                           global state;
  * ``Analysis``         — the per-target accumulator: flags findings,
                           then applies waivers deterministically.

Waiver grammar (both the det-lint CLI and purity analysis honor it):

  ``# det-lint: waive[rule1,rule2] reason=why this is legitimately real``
      on the offending line (or alone on the line directly above it);
  ``# det-lint: file waive[rule] reason=...``
      anywhere in the file — waives the rule for the whole file.

``waive[*]`` waives every rule at that scope. A pragma without a
``reason=`` is itself a finding (``bad-waiver``): waivers must name the
contract they invoke (real-exec vs. modeled path).
"""
from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .findings import ERROR, Finding, Report

PRAGMA_RE = re.compile(
    r"#\s*det-lint:\s*(?P<file>file\s+)?waive\[(?P<rules>[^\]]*)\]"
    r"(?:\s+reason=(?P<reason>.*?))?\s*$"
)


class Waivers:
    """Parsed waiver pragmas for one source file."""

    def __init__(self) -> None:
        # lineno -> {rule or "*": reason}
        self.line: Dict[int, Dict[str, str]] = {}
        # rule or "*" -> reason (file scope)
        self.file: Dict[str, str] = {}
        self.bad: List[Tuple[int, str]] = []  # (lineno, message)

    def reason_for(self, rule: str, lineno: int) -> Optional[str]:
        """Waiver reason covering ``rule`` at ``lineno``, or None."""
        for scope in (self.line.get(lineno, {}), self.file):
            hit = scope.get(rule, scope.get("*"))
            if hit is not None:
                return hit
        return None


def parse_pragmas(lines: Sequence[str], *, first_lineno: int = 1) -> Waivers:
    """Extract waiver pragmas from source lines.

    ``first_lineno`` is the file lineno of ``lines[0]`` — payload
    analysis parses a dedented block but records findings in file
    coordinates, so its waivers must live there too. A pragma on a line
    that holds *only* the comment also covers the next line, so hazards
    can be annotated above long statements.
    """
    w = Waivers()
    for i, raw in enumerate(lines, start=first_lineno):
        m = PRAGMA_RE.search(raw)
        if not m:
            continue
        rules = [r.strip() for r in m.group("rules").split(",") if r.strip()]
        reason = (m.group("reason") or "").strip()
        if not rules:
            w.bad.append((i, "waiver pragma with empty rule list"))
            continue
        if not reason:
            w.bad.append((i, "waiver pragma missing reason="))
            continue
        entry = {r: reason for r in rules}
        if m.group("file"):
            w.file.update(entry)
            continue
        w.line.setdefault(i, {}).update(entry)
        if raw.lstrip().startswith("#"):  # comment-only line: cover next
            w.line.setdefault(i + 1, {}).update(entry)
    return w


class ImportTable:
    """Canonicalize dotted names against a file's imports.

    ``import numpy as np``            -> np.X        => numpy.X
    ``from time import perf_counter`` -> perf_counter => time.perf_counter
    ``from datetime import datetime`` -> datetime.now => datetime.datetime.now

    ``runtime`` (a function's ``__globals__`` merged with its closure
    cells) takes precedence when available — payload analysis resolves
    roots against the live namespace, so aliases never fool it.
    """

    def __init__(self, runtime: Optional[Dict[str, object]] = None) -> None:
        self.aliases: Dict[str, str] = {}
        self.runtime = runtime or {}

    @classmethod
    def from_tree(cls, tree: ast.AST,
                  runtime: Optional[Dict[str, object]] = None
                  ) -> "ImportTable":
        table = cls(runtime)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    table.aliases[a.asname or a.name.split(".")[0]] = a.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    table.aliases[a.asname or a.name] = (
                        f"{node.module}.{a.name}")
        return table

    def _canon_root(self, root: str) -> Optional[str]:
        obj = self.runtime.get(root)
        if obj is not None:
            mod = getattr(obj, "__name__", None)
            if isinstance(obj, type(ast)):        # a module object
                return mod
            qual = getattr(obj, "__qualname__", None)
            owner = getattr(obj, "__module__", None)
            if qual and owner:
                return f"{owner}.{qual}"
        return self.aliases.get(root)

    def resolve(self, dotted: str) -> str:
        """Rewrite the root segment to its canonical module path."""
        root, _, rest = dotted.partition(".")
        canon = self._canon_root(root)
        if canon is None:
            return dotted
        return f"{canon}.{rest}" if rest else canon


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for an Attribute chain rooted at a Name, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def root_name(node: ast.AST) -> Optional[str]:
    """Base Name of an Attribute/Subscript/Starred chain, else None."""
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Starred)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def parent_map(tree: ast.AST) -> Dict[ast.AST, ast.AST]:
    parents: Dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def _bind_target(target: ast.AST, names: Set[str]) -> None:
    # only structural targets bind names; ``x[i] = v`` / ``x.a = v``
    # *mutate* x (the global-mutation rule's business), they don't bind it
    if isinstance(target, ast.Name):
        names.add(target.id)
    elif isinstance(target, (ast.Tuple, ast.List)):
        for elt in target.elts:
            _bind_target(elt, names)
    elif isinstance(target, ast.Starred):
        _bind_target(target.value, names)


def collect_bindings(fn_node: ast.AST) -> Set[str]:
    """Names bound anywhere in a function body (its local scope).

    Conservative: nested ``def``/``lambda`` parameters are included too,
    which can only *suppress* findings (never invent them) — acceptable
    for a lint whose errors must be trustworthy.
    """
    names: Set[str] = set()
    args = getattr(fn_node, "args", None)
    if args is not None:
        for a in (list(args.posonlyargs) + list(args.args)
                  + list(args.kwonlyargs)):
            names.add(a.arg)
        if args.vararg:
            names.add(args.vararg.arg)
        if args.kwarg:
            names.add(args.kwarg.arg)
    for node in ast.walk(fn_node):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                _bind_target(t, names)
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            _bind_target(node.target, names)
        elif isinstance(node, ast.comprehension):
            _bind_target(node.target, names)
        elif isinstance(node, ast.NamedExpr):
            _bind_target(node.target, names)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                if item.optional_vars is not None:
                    _bind_target(item.optional_vars, names)
        elif isinstance(node, ast.ExceptHandler) and node.name:
            names.add(node.name)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.arg):
            names.add(node.arg)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                names.add((a.asname or a.name).split(".")[0])
    return names


def set_typed_locals(scope_node: ast.AST) -> Set[str]:
    """Names assigned a syntactically-evident set expression in scope."""
    out: Set[str] = set()
    for node in ast.walk(scope_node):
        if isinstance(node, ast.Assign) and is_set_expr(node.value):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
        elif (isinstance(node, ast.AnnAssign) and node.value is not None
              and is_set_expr(node.value)
              and isinstance(node.target, ast.Name)):
            out.add(node.target.id)
    return out


def is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        return node.func.id in ("set", "frozenset")
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)):
        return is_set_expr(node.left) or is_set_expr(node.right)
    return False


class Analysis:
    """Per-target accumulator: rules flag into it, waivers apply once.

    ``line_offset`` shifts node linenos into file coordinates when the
    analyzed tree was parsed from a dedented block (payload analysis).
    """

    def __init__(self, file: str, *, waivers: Optional[Waivers] = None,
                 line_offset: int = 0, function: str = "") -> None:
        self.file = file
        self.waivers = waivers or Waivers()
        self.line_offset = line_offset
        self.function = function
        self._findings: List[Finding] = []
        for lineno, msg in self.waivers.bad:
            self._findings.append(Finding(
                rule="bad-waiver", severity=ERROR, file=file,
                line=lineno, message=msg, function=function))

    def flag(self, rule: str, node: ast.AST, message: str, *,
             severity: str = ERROR, function: Optional[str] = None) -> None:
        line = getattr(node, "lineno", 0) + self.line_offset
        reason = self.waivers.reason_for(rule, line)
        self._findings.append(Finding(
            rule=rule, severity=severity, file=self.file, line=line,
            message=message,
            function=self.function if function is None else function,
            waived=reason is not None, waive_reason=reason or ""))

    def findings(self) -> List[Finding]:
        return list(self._findings)

    def report(self) -> Report:
        return Report(self._findings)
