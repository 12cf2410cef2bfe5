"""Static analysis guarding Dandelion's two load-bearing contracts.

Three passes share one AST-walker core (:mod:`.walker`, :mod:`.rules`)
and one result model (:mod:`.findings`):

  * :mod:`.purity`    — the pure-function contract for compute payloads
    (``sdk.verify`` / ``Platform(verify=...)`` sit on top of this);
  * :mod:`.graphlint` — shape checks on the built Composition IR;
  * :mod:`.detlint`   — byte-identity hazards in the simulator's own
    sources (``python -m repro_torch.analysis.detlint``).

Counterpart of ``repro.analysis``. The one change is the ``rng`` rule,
which also flags torch's global generator (``rules.TORCH_GLOBAL_FNS``
without ``generator=``, ``torch.manual_seed``/``torch.seed``): a torch
payload has one, where a JAX payload has none.

This package imports only the standard library and ``repro_torch.core`` —
never ``repro_torch.sdk`` — so the SDK can layer verification on top without
an import cycle.
"""
from .findings import (ERROR, INFO, RULES, SEVERITIES, WARN, Finding,
                       PurityReport, Report)
from .graphlint import lint_composition, registration_lint_hook
from .purity import analyze_callable, clear_cache, verify_functions
from .detlint import lint_paths, lint_source

__all__ = [
    "ERROR", "INFO", "WARN", "SEVERITIES", "RULES",
    "Finding", "Report", "PurityReport",
    "analyze_callable", "verify_functions", "clear_cache",
    "lint_composition", "registration_lint_hook",
    "lint_paths", "lint_source",
]
