#!/usr/bin/env python
"""A markdown table of a dry-run directory's cells (``repro_torch.launch.dryrun``).

One row an (arch, shape): each mesh's counted FLOPs over ``model_flops``,
bottleneck and peak GiB a device, and (single-pod mesh) the shares of the
counted FLOPs: dense matmuls, batched matmuls (einsum: MoE dispatch and
combine, attention's gradient), the attention kernels, and ``moe_gmm`` and
``ssd`` with their backward kernels.

Usage: PYTHONPATH=src python tools/dryrun_table.py results/dryrun_torch
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
           ("attn", ("kernel:flash_attention", "kernel:decode_attention")),
           ("gmm/ssd", ("kernel:moe_gmm", "kernel:ssd", "kernel:moe_gmm_backward",
                        "kernel:ssd_backward")))


def report(out_dir: str) -> str:
    """The table of the cells under ``out_dir``."""
    cells: Dict[Tuple[str, str], Dict[str, Any]] = {}
    for name in sorted(os.listdir(out_dir)):
        if name.endswith(".json"):
            with open(os.path.join(out_dir, name)) as f:
                c = json.load(f)
            cells.setdefault((c["arch"], c["shape"]), {})[c["mesh"]] = c
    head = ("| arch | shape | counted FLOPs x devices | model_flops | ratio single / multi | "
            "bottleneck single / multi | peak GiB a device single / multi | "
            + " | ".join(f"{k} share" for k, _ in _SHARES) + " |")
    lines = [head, "|" + "---|" * (7 + len(_SHARES))]
    order = {a: i for i, a in enumerate(ARCH_IDS)}
    for (arch, shape), by_mesh in sorted(cells.items(), key=lambda kv: (
            order.get(kv[0][0], 99), SHAPE_ORDER.index(kv[0][1]) if kv[0][1] in SHAPE_ORDER
            else 99)):
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
    print(report(sys.argv[1]), end="")
