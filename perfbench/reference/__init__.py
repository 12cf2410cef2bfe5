"""A configuration's plain reference, found by name.

A configuration file may name its module with ``"reference": "<module>"``, which is
``perfbench/reference/<module>.py``; without the key it is ``model`` (the Llama-style
dense and MoE decoders). ``for_config`` finds the file by that name, as
``harness.reader_for`` finds a metric's reader, and refuses a module that imports
JAX, the JAX package or the program (``harness.FORBIDDEN`` and ``repro_torch``),
itself or through the benchmark's own modules it imports.

A reference module gives:

* ``Arch``: ``Arch.from_config(config)`` reads a configuration file into the sizes the
  reference needs; its ``family`` names the module's entry of ``SMOKE``, its
  ``layers`` the number of layers, its ``vocab`` the vocabulary.
* ``weight_spec(a)``: every parameter as ``(path, shape, dtype, init)``, in a fixed
  order and in the layout the program takes: per-layer leaves under ``blocks``,
  stacked with the layer first.
* ``make_weights(a, seed, device)``: the nested parameter tree, drawn on ``device``
  from ``seed``; ``make_leaf(a, seed, path, device)`` draws one leaf of it again.
* ``leaves(tree)``: ``(path, tensor)`` of every leaf of a nested tree.
* ``split_layers(params, a, dtype)``: the tree with ``blocks`` a list of per-layer
  trees, every leaf a tensor of its own in ``dtype``.
* ``next_token_logits(params, tokens, rows, a, quant=None)``: one sequence's logits at
  ``rows``; ``train_loss(params, tokens, targets, a, quant=None)``: the training loss.
  ``quant`` names the control's lower precision, None is the reference itself.
* ``no_tf32()``: the matrix products in full float32.
* The model arithmetic the per-layer metrics read: ``prefill_flops(config, n)`` (a
  prompt of ``n`` tokens), ``decode_flops(config, context)`` (one generated token at a
  context of ``context`` positions), ``train_flops(config, batch, seq)`` (a training
  step), and ``cache_bytes(config, cell)`` (the slot cache a served cell reserves).
* ``SMOKE``: family -> the configuration keys that ``perfbench.smoke`` sets for a cell
  at a size the CPU runs in a second or two.
"""
from __future__ import annotations

import ast
import functools
import importlib
import re
from pathlib import Path
from typing import List

from perfbench.harness import FORBIDDEN

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent
REFUSED = FORBIDDEN + ("repro_torch",)   # top-level module names, compared whole


def for_config(config: dict):
    """The reference module that ``config`` names (``model`` without the key)."""
    return _module(config.get("reference", "model"))


@functools.lru_cache(maxsize=None)
def _module(name: str):
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name) or not (HERE / f"{name}.py").exists():
        raise ValueError(f"no reference module {name!r} in {HERE}")
    bad = forbidden_imports(HERE / f"{name}.py")
    if bad:
        raise ImportError(f"reference module {name!r} imports {bad}")
    return importlib.import_module(f"{__name__}.{name}")


def forbidden_imports(path: Path, root: Path = ROOT) -> List[str]:
    """The names of ``REFUSED`` that the module at ``path`` imports, itself or through
    the benchmark's own modules it imports (read from their sources under ``root``, the
    checkout, not run)."""
    todo, seen, bad = [Path(path).resolve()], set(), set()
    while todo:
        p = todo.pop()
        if p in seen:
            continue
        seen.add(p)
        for name in _imported(p, root):
            top = name.split(".")[0]
            if top in REFUSED:
                bad.add(top)
            elif top == "perfbench":
                base = root.joinpath(*name.split("."))
                todo += [f for f in (base.with_suffix(".py"), base / "__init__.py") if f.exists()]
    return sorted(bad)


def _imported(path: Path, root: Path) -> List[str]:
    """Every module name an import statement of ``path`` may load: of ``from m import
    x``, both ``m`` and ``m.x``; a relative name made absolute (the package of ``path``
    under ``root``)."""
    package = list(path.relative_to(root).parts[:-1]) if path.is_relative_to(root) else []
    names: List[str] = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            parent = package[:len(package) + 1 - node.level] if node.level else []
            module = ".".join(parent + ([node.module] if node.module else []))
            names += [module] + [f"{module}.{a.name}" for a in node.names]
    return names
