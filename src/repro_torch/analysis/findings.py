"""Structured findings: the shared result model of every analysis pass.

A ``Finding`` is one rule violation at one source location (or graph
location, for composition lint): rule id, severity, ``file:line``, a
human message naming the culprit, and — when a waiver applies — the
waiver reason. A ``Report`` is a *deterministically ordered* collection
of findings: two runs over the same tree render byte-identical text,
which is what lets ``tools/det_lint.py`` and ``sdk.verify`` act as CI
gates without flaking.

Severity semantics (the contract every consumer shares):

  * ``error`` — violates a hard contract (purity / byte-identity);
    unwaived errors are *blocking*: strict mode raises, det-lint exits 1;
  * ``warn``  — probably a bug, statically unprovable (e.g. a retry
    policy on a COMM vertex whose payload methods are runtime data);
  * ``info``  — stylistic / informational (dangling output ports).

Waived findings stay in the report (auditable) but never block.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Iterable, List, Tuple

ERROR, WARN, INFO = "error", "warn", "info"
SEVERITIES = (ERROR, WARN, INFO)

#: rule id -> one-line description; the catalog docs/ARCHITECTURE.md
#: documents and tests/test_analysis.py covers rule-by-rule.
RULES: Dict[str, str] = {
    # purity rules (compute-function bodies; all ERROR)
    "io": "file/network/subprocess/stdout I/O in a compute body",
    "wall-clock": "wall-clock or process-timer read (time.*, datetime.now)",
    "rng": "unseeded or global-state RNG (random.*, np.random.<fn>)",
    "global-mutation": "mutation of module globals or closed-over state",
    "set-iter": "iteration over a set (hash-ordered, PYTHONHASHSEED-unstable)",
    "builtin-hash": "builtin hash() (salted per process for str/bytes)",
    "source-unavailable": "payload source cannot be retrieved for analysis",
    # determinism-lint extras (simulator sources)
    "id-order": "id()-based ordering (sort key / heap entry)",
    "bad-waiver": "waiver pragma missing its reason= or rule list",
    # composition lint (graph-level)
    "graph-unreachable": "vertex unreachable from any composition input",
    "graph-dangling-output": "output set feeds no edge and no output binding",
    "graph-comm-retry": "RetryPolicy on a COMM vertex (idempotency is runtime data)",
    "graph-fanout-local": "each/key fan-out confined to one node (no crossnode)",
}


@dataclass(frozen=True)
class Finding:
    """One rule violation at one location."""

    rule: str
    severity: str
    file: str
    line: int
    message: str
    function: str = ""          # offending function / vertex, when known
    waived: bool = False
    waive_reason: str = ""

    def sort_key(self) -> Tuple:
        return (self.file, self.line, self.rule, self.function, self.message)

    def render(self) -> str:
        loc = f"{self.file}:{self.line}" if self.line else self.file
        who = f" {self.function}:" if self.function else ""
        tail = f"  [waived: {self.waive_reason}]" if self.waived else ""
        return f"{loc}: {self.severity} [{self.rule}]{who} {self.message}{tail}"

    def waive(self, reason: str) -> "Finding":
        return replace(self, waived=True, waive_reason=reason)


class Report:
    """Deterministically ordered findings + blocking/ok semantics."""

    def __init__(self, findings: Iterable[Finding] = ()):
        self.findings: Tuple[Finding, ...] = tuple(
            sorted(findings, key=Finding.sort_key)
        )

    # ------------------------------------------------------------ views
    @property
    def unwaived(self) -> List[Finding]:
        return [f for f in self.findings if not f.waived]

    @property
    def waived(self) -> List[Finding]:
        return [f for f in self.findings if f.waived]

    @property
    def blocking(self) -> List[Finding]:
        """Unwaived errors: what strict mode / det-lint fail on."""
        return [f for f in self.findings
                if not f.waived and f.severity == ERROR]

    @property
    def ok(self) -> bool:
        return not self.blocking

    def by_rule(self, rule: str) -> List[Finding]:
        return [f for f in self.findings if f.rule == rule]

    # ---------------------------------------------------------- render
    def render(self, *, show_waived: bool = True) -> str:
        shown = self.findings if show_waived else self.unwaived
        lines = [f.render() for f in shown]
        lines.append(
            f"{len(self.findings)} finding(s): "
            f"{len(self.blocking)} blocking, "
            f"{len(self.unwaived) - len(self.blocking)} advisory, "
            f"{len(self.waived)} waived"
        )
        return "\n".join(lines)

    def __len__(self) -> int:
        return len(self.findings)

    def __iter__(self):
        return iter(self.findings)

    def __repr__(self):
        return (f"Report({len(self.findings)} findings, "
                f"{len(self.blocking)} blocking)")


class PurityReport(Report):
    """``sdk.verify`` result: findings plus what was checked and which
    declarations opted out via ``pure_unsafe=True`` (recorded, per the
    escape-hatch contract)."""

    def __init__(self, findings: Iterable[Finding] = (), *,
                 checked: Iterable[str] = (), unsafe: Iterable[str] = ()):
        super().__init__(findings)
        self.checked: Tuple[str, ...] = tuple(checked)
        self.unsafe: Tuple[str, ...] = tuple(unsafe)

    def render(self, *, show_waived: bool = True) -> str:
        head = (f"verified {len(self.checked)} function(s)"
                + (f"; pure_unsafe: {', '.join(self.unsafe)}"
                   if self.unsafe else ""))
        return head + "\n" + super().render(show_waived=show_waived)

    def __repr__(self):
        return (f"PurityReport({len(self.checked)} checked, "
                f"{len(self.blocking)} blocking, "
                f"{len(self.unsafe)} pure_unsafe)")
