"""Rule predicates shared by the purity verifier and the determinism lint.

Each ``check_*`` takes an AST node plus a :class:`RuleContext` and flags
findings into the context's :class:`~repro_torch.analysis.walker.Analysis`.
The purity pass runs the full list over compute-function bodies; the
det-lint pass runs the byte-identity subset (wall-clock, rng, set-iter,
id-order, builtin-hash) over whole simulator modules — I/O and mutation
are legitimate for the simulator itself, which *models* a cluster.

Name matching is canonical, not textual: ``np.random.normal`` and
``numpy.random.normal`` resolve identically through the
:class:`~repro_torch.analysis.walker.ImportTable` (file imports for det-lint,
the live ``__globals__`` for payload analysis), so aliasing cannot dodge
a rule.
"""
from __future__ import annotations

import ast
from typing import FrozenSet, Optional

from .walker import (Analysis, ImportTable, dotted_name, is_set_expr,
                     root_name)

# --------------------------------------------------------------- catalogs
WALL_CLOCK_CALLS = frozenset({
    "time.time", "time.time_ns", "time.perf_counter",
    "time.perf_counter_ns", "time.monotonic", "time.monotonic_ns",
    "time.process_time", "time.process_time_ns", "time.clock_gettime",
    "time.sleep",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today",
})

# stdlib ``random`` functions that draw from the process-global RNG
RANDOM_GLOBAL_FNS = frozenset({
    "random", "randint", "randrange", "choice", "choices", "shuffle",
    "sample", "uniform", "triangular", "gauss", "normalvariate",
    "lognormvariate", "expovariate", "vonmisesvariate", "betavariate",
    "paretovariate", "weibullvariate", "getrandbits", "randbytes", "seed",
})

# ``numpy.random`` module-level functions backed by the global RandomState
NP_GLOBAL_FNS = frozenset({
    "seed", "random", "rand", "randn", "randint", "random_sample",
    "random_integers", "ranf", "sample", "choice", "shuffle",
    "permutation", "bytes", "uniform", "normal", "standard_normal",
    "poisson", "exponential", "beta", "binomial", "gamma", "lognormal",
    "laplace", "gumbel", "logistic", "multinomial",
    "multivariate_normal", "dirichlet", "geometric", "hypergeometric",
    "negative_binomial", "pareto", "power", "rayleigh", "triangular",
    "vonmises", "wald", "weibull", "zipf", "chisquare", "f",
    "noncentral_chisquare", "noncentral_f", "standard_cauchy",
    "standard_exponential", "standard_gamma", "standard_t",
})

# ``torch`` functions that draw from the global generator unless they are
# given a ``generator=``, and the calls that (re)seed that generator: a
# torch payload's counterpart of the ``numpy.random`` globals
TORCH_GLOBAL_FNS = frozenset({
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial",
})
TORCH_SEED_FNS = frozenset({"manual_seed", "seed"})

IO_ROOT_PREFIXES = (
    "subprocess.", "socket.", "shutil.", "requests.", "urllib.",
    "http.client.", "ftplib.", "smtplib.", "sqlite3.",
    "sys.stdout.", "sys.stderr.", "sys.stdin.",
)

MUTATING_METHODS = frozenset({
    "append", "extend", "insert", "remove", "pop", "clear", "update",
    "add", "discard", "setdefault", "popitem", "sort", "reverse",
    "write", "writelines", "send", "put",
})

# aggregates whose result does not depend on iteration order
ORDER_INSENSITIVE = frozenset({
    "sum", "min", "max", "any", "all", "len", "sorted", "set",
    "frozenset",
})


class RuleContext:
    """Everything a rule needs about the tree under analysis."""

    def __init__(self, analysis: Analysis, imports: ImportTable,
                 parents, *, local_names: FrozenSet[str] = frozenset(),
                 set_locals: FrozenSet[str] = frozenset()) -> None:
        self.analysis = analysis
        self.imports = imports
        self.parents = parents
        self.local_names = frozenset(local_names)
        self.set_locals = frozenset(set_locals)

    def canon(self, node: ast.AST) -> Optional[str]:
        dotted = dotted_name(node)
        if dotted is None:
            return None
        root = dotted.split(".", 1)[0]
        if root in self.local_names:     # shadowed by a local binding
            return None
        return self.imports.resolve(dotted)

    def flag(self, rule: str, node: ast.AST, message: str, *,
             severity: str = "error") -> None:
        self.analysis.flag(rule, node, message, severity=severity)


# ------------------------------------------------------------ byte-identity
def check_wall_clock(node: ast.AST, ctx: RuleContext) -> None:
    if not isinstance(node, ast.Call):
        return
    canon = ctx.canon(node.func)
    if canon in WALL_CLOCK_CALLS:
        ctx.flag("wall-clock", node,
                 f"{canon}() reads the host clock; modeled paths must "
                 f"take time from the event loop")


def check_rng(node: ast.AST, ctx: RuleContext) -> None:
    if not isinstance(node, ast.Call):
        return
    canon = ctx.canon(node.func)
    if canon is None:
        return
    seeded = bool(node.args or node.keywords)
    if canon.startswith("random."):
        attr = canon.split(".", 1)[1]
        if attr in RANDOM_GLOBAL_FNS:
            ctx.flag("rng", node,
                     f"{canon}() draws from the process-global RNG; "
                     f"use a seeded random.Random(seed)")
        elif attr == "Random" and not seeded:
            ctx.flag("rng", node, "random.Random() without a seed")
        elif attr == "SystemRandom":
            ctx.flag("rng", node, "random.SystemRandom is entropy-backed "
                                  "and never reproducible")
    elif canon.startswith("numpy.random."):
        attr = canon.split(".", 2)[2] if canon.count(".") >= 2 else ""
        if attr == "default_rng" and not seeded:
            ctx.flag("rng", node,
                     "numpy.random.default_rng() without a seed")
        elif attr == "RandomState" and not seeded:
            ctx.flag("rng", node,
                     "numpy.random.RandomState() without a seed")
        elif attr in NP_GLOBAL_FNS:
            ctx.flag("rng", node,
                     f"numpy.random.{attr}() uses the global RandomState; "
                     f"use a seeded default_rng(seed)")
    elif canon.startswith("torch.") and canon.count(".") == 1:
        attr = canon.split(".", 1)[1]
        if attr in TORCH_SEED_FNS:
            ctx.flag("rng", node,
                     f"{canon}() seeds the global generator; pass a seeded "
                     f"torch.Generator as generator=")
        elif attr in TORCH_GLOBAL_FNS and not any(
                kw.arg == "generator" for kw in node.keywords):
            ctx.flag("rng", node,
                     f"{canon}() without generator= draws from the global "
                     f"generator; pass a seeded torch.Generator")


def check_builtin_hash(node: ast.AST, ctx: RuleContext) -> None:
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id == "hash"
            and "hash" not in ctx.local_names
            and ctx.imports.resolve("hash") == "hash"):
        ctx.flag("builtin-hash", node,
                 "hash() on str/bytes is salted per process "
                 "(PYTHONHASHSEED); use zlib.crc32 or hashlib for "
                 "stable digests")


def _is_setty(expr: ast.AST, ctx: RuleContext) -> bool:
    if is_set_expr(expr):
        return True
    return isinstance(expr, ast.Name) and expr.id in ctx.set_locals


def check_set_iter(node: ast.AST, ctx: RuleContext) -> None:
    if isinstance(node, (ast.For, ast.AsyncFor)):
        if _is_setty(node.iter, ctx):
            ctx.flag("set-iter", node.iter,
                     "for-loop over a set: iteration order follows the "
                     "hash seed; wrap in sorted(...)")
        return
    if isinstance(node, (ast.GeneratorExp, ast.ListComp, ast.SetComp,
                         ast.DictComp)):
        parent = ctx.parents.get(node)
        if (isinstance(parent, ast.Call)
                and isinstance(parent.func, ast.Name)
                and parent.func.id in ORDER_INSENSITIVE):
            return                       # sum(... for x in S) is order-safe
        for gen in node.generators:
            if _is_setty(gen.iter, ctx):
                ctx.flag("set-iter", gen.iter,
                         "comprehension over a set feeds an "
                         "order-sensitive consumer; wrap in sorted(...)")


def _is_id_call(expr: ast.AST) -> bool:
    return (isinstance(expr, ast.Call)
            and isinstance(expr.func, ast.Name) and expr.func.id == "id")


def _orders_by_id(expr: ast.AST) -> bool:
    """True when ``expr``'s *value* is an id() (directly or as a tuple
    component) — i.e. the ordering itself is an object address. id()
    merely appearing inside a subscript/call (identity-keyed dict
    lookups like ``load[id(n)]``) is deterministic data access, not
    address-based ordering, and is not flagged."""
    if _is_id_call(expr):
        return True
    if isinstance(expr, (ast.Tuple, ast.List)):
        return any(_is_id_call(e) for e in expr.elts)
    return False


def check_id_order(node: ast.AST, ctx: RuleContext) -> None:
    if not isinstance(node, ast.Call):
        return
    canon = ctx.canon(node.func)
    if canon in ("sorted", "min", "max"):
        for kw in node.keywords:
            if kw.arg == "key" and (
                    (isinstance(kw.value, ast.Name) and kw.value.id == "id")
                    or (isinstance(kw.value, ast.Lambda)
                        and _orders_by_id(kw.value.body))):
                ctx.flag("id-order", node,
                         f"{canon}(key=id): object addresses vary per "
                         f"process; order by a stable field")
    elif canon in ("heapq.heappush", "heapq.heappushpop", "heapq.heapify",
                   "heapq.merge"):
        for arg in node.args[1:] or node.args:
            if _orders_by_id(arg):
                ctx.flag("id-order", node,
                         f"{canon} entry contains id(): heap order "
                         f"becomes address-dependent; use a sequence "
                         f"counter")


# ----------------------------------------------------------------- purity
def check_io(node: ast.AST, ctx: RuleContext) -> None:
    if not isinstance(node, ast.Call):
        return
    if isinstance(node.func, ast.Name) and node.func.id not in ctx.local_names:
        if node.func.id in ("open", "input"):
            ctx.flag("io", node, f"{node.func.id}() performs host I/O")
            return
        if node.func.id == "print":
            ctx.flag("io", node, "print() writes to stdout — side effect "
                                 "outside the declared outputs")
            return
    canon = ctx.canon(node.func)
    if canon is None:
        return
    if canon in ("builtins.open", "builtins.input", "io.open"):
        ctx.flag("io", node, f"{canon}() performs host I/O")
    elif canon == "builtins.print":
        ctx.flag("io", node, "print() writes to stdout — side effect "
                             "outside the declared outputs")
    elif canon.startswith(IO_ROOT_PREFIXES):
        ctx.flag("io", node, f"{canon}() reaches outside the sandbox "
                             f"(file/network/process I/O)")
    elif canon.startswith("os.") and not canon.startswith("os.path."):
        ctx.flag("io", node, f"{canon}() touches host OS state; pure "
                             f"functions see only their declared inputs")


def check_global_mutation(node: ast.AST, ctx: RuleContext) -> None:
    if isinstance(node, ast.Global):
        ctx.flag("global-mutation", node,
                 f"global {', '.join(node.names)}: rebinding module "
                 f"state breaks idempotent re-execution")
        return
    if isinstance(node, ast.Nonlocal):
        ctx.flag("global-mutation", node,
                 f"nonlocal {', '.join(node.names)}: rebinding "
                 f"closed-over state breaks idempotent re-execution")
        return
    if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target])
        for t in targets:
            if isinstance(t, (ast.Attribute, ast.Subscript)):
                root = root_name(t)
                if root is not None and root not in ctx.local_names:
                    ctx.flag("global-mutation", node,
                             f"assignment into non-local '{root}' mutates "
                             f"state shared across invocations")
        return
    if isinstance(node, ast.Delete):
        for t in node.targets:
            if isinstance(t, (ast.Attribute, ast.Subscript)):
                root = root_name(t)
                if root is not None and root not in ctx.local_names:
                    ctx.flag("global-mutation", node,
                             f"del on non-local '{root}' mutates shared "
                             f"state")
        return
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr in MUTATING_METHODS):
        root = root_name(node.func.value)
        if root is not None and root not in ctx.local_names:
            ctx.flag("global-mutation", node,
                     f"'{root}.{node.func.attr}(...)' mutates non-local "
                     f"state shared across invocations")


#: byte-identity subset (det-lint over simulator sources)
DETERMINISM_CHECKS = (check_wall_clock, check_rng, check_builtin_hash,
                      check_set_iter, check_id_order)

#: full purity contract (compute-function bodies)
PURITY_CHECKS = DETERMINISM_CHECKS + (check_io, check_global_mutation)
