#!/usr/bin/env python
"""A markdown table of a dry-run directory's cells (``repro_torch.launch.dryrun``).

One row an (arch, shape): each mesh's counted FLOPs over ``model_flops``,
bottleneck and peak GiB a device, and (single-pod mesh) the shares of the
counted FLOPs: dense matmuls, batched matmuls (einsum: MoE dispatch and
combine), the attention kernels with flash's backward kernel, and ``moe_gmm`` and
``ssd`` with their backward kernels.

With two directories (``--compare A B``, e.g. a grid at ``--grad-accum 1`` and one
at ``--grad-accum 4``) it prints one row a cell of both: counted FLOPs and collective
link bytes a device in each, and B over A.

Usage: PYTHONPATH=src python tools/dryrun_table.py results/dryrun_torch
       PYTHONPATH=src python tools/dryrun_table.py --compare DIR_A DIR_B
"""
from __future__ import annotations

import json
import os
import sys
from typing import Any, Dict, Tuple

from repro_torch.config.shapes import SHAPE_ORDER
from repro_torch.configs import ARCH_IDS
from repro_torch.launch.dryrun import MESHES

_SHARES = (("mm", ("aten.mm", "aten.addmm")), ("bmm", ("aten.bmm", "aten.baddbmm")),
           ("attn", ("kernel:flash_attention", "kernel:flash_attention_backward",
                     "kernel:decode_attention")),
           ("gmm/ssd", ("kernel:moe_gmm", "kernel:ssd", "kernel:moe_gmm_backward",
                        "kernel:ssd_backward")))


def _cells(out_dir: str) -> Dict[Tuple[str, str], Dict[str, Any]]:
    """(arch, shape) -> mesh -> the cell's JSON, of every cell under ``out_dir``."""
    cells: Dict[Tuple[str, str], Dict[str, Any]] = {}
    for name in sorted(os.listdir(out_dir)):
        if name.endswith(".json"):
            with open(os.path.join(out_dir, name)) as f:
                c = json.load(f)
            cells.setdefault((c["arch"], c["shape"]), {})[c["mesh"]] = c
    return cells


def _order(key: Tuple[str, str]):
    order = {a: i for i, a in enumerate(ARCH_IDS)}
    return order.get(key[0], 99), SHAPE_ORDER.index(key[1]) if key[1] in SHAPE_ORDER else 99


def compare(dir_a: str, dir_b: str) -> str:
    """One row a (arch, shape, mesh) counted in both directories: FLOPs and collective
    link bytes a device in A and in B, and B / A; a cell that failed in either says
    which."""
    a, b = _cells(dir_a), _cells(dir_b)
    lines = ["| arch | shape | mesh | FLOPs a device A | B | B / A | collective bytes a device A "
             "| B | B / A |", "|" + "---|" * 9]
    for key in sorted(set(a) | set(b), key=_order):
        for mesh in sorted(set(a.get(key, {})) | set(b.get(key, {}))):
            ca, cb = a.get(key, {}).get(mesh), b.get(key, {}).get(mesh)
            if not all(c and "roofline" in c for c in (ca, cb)):
                state = lambda c: "missing" if not c else c.get("error", c.get("skipped", "?"))
                lines.append(f"| {key[0]} | {key[1]} | {mesh} | {state(ca)} | {state(cb)} "
                             "| | | | |")
                continue
            fa, fb = (c["roofline"]["flops_per_device"] for c in (ca, cb))
            la, lb = (c["roofline"]["collective_link_bytes_per_device"] for c in (ca, cb))
            lines.append(f"| {key[0]} | {key[1]} | {mesh} | {fa:.4e} | {fb:.4e} | {fb / fa:.4f} "
                         f"| {la:.4e} | {lb:.4e} | {lb / la:.3f} |")
    return "\n".join(lines) + "\n"


def report(out_dir: str) -> str:
    """The table of the cells under ``out_dir``."""
    cells = _cells(out_dir)
    head = ("| arch | shape | counted FLOPs x devices | model_flops | ratio single / multi | "
            "bottleneck single / multi | peak GiB a device single / multi | "
            + " | ".join(f"{k} share" for k, _ in _SHARES) + " |")
    lines = [head, "|" + "---|" * (7 + len(_SHARES))]
    for (arch, shape), by_mesh in sorted(cells.items(), key=lambda kv: _order(kv[0])):
        single, multi = by_mesh.get(MESHES["single"][0]), by_mesh.get(MESHES["multi"][0])
        ran = [c for c in (single, multi) if c and "roofline" in c]
        if not ran:
            continue
        first = ran[0]
        pair = lambda f: " / ".join(f(c) if c and "roofline" in c else "-" for c in (single, multi))
        ratio = lambda c: "%.3f" % c["counted_over_model_flops"]
        peak = lambda c: "%.1f" % (c["memory"]["peak_bytes_per_device"] / 2**30)
        by_op = first["cost_corrected"].get("flops_by_op", {})
        total = first["cost_corrected"]["flops"] or 1.0
        shares = ["%.3f" % (sum(by_op.get(o, 0.0) for o in names) / total) for _, names in _SHARES]
        lines.append(
            f"| {arch} | {shape} | {first['cost_corrected']['flops'] * first['devices']:.4e} | "
            f"{first['roofline']['model_flops']:.4e} | {pair(ratio)} | "
            f"{pair(lambda c: c['roofline']['bottleneck'])} | {pair(peak)} | "
            + " | ".join(shares) + " |")
    return "\n".join(lines) + "\n"


if __name__ == "__main__":
    if sys.argv[1] == "--compare":
        print(compare(sys.argv[2], sys.argv[3]), end="")
    else:
        print(report(sys.argv[1]), end="")
