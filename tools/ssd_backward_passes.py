#!/usr/bin/env python
"""The ssd backward kernel's device ms by pass, bf16 and float32, at the training
shapes (``chip_smoke.ssd_backward_passes``), for the package under each source
directory given: this checkout's ``src`` when none is. Each directory's kernels
are built from its own sources (into ``build/`` beside it) and timed in a process
of its own, so a parent commit unpacked into a gitignored directory can be timed
in the same run as this one. Needs a CUDA card and ``nvcc``.

Usage: python tools/ssd_backward_passes.py [SRC ...]   (from the repo root)
"""
from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--one":
        sys.path[:0] = [os.path.abspath(sys.argv[2]), ROOT]
        import torch

        import chip_smoke
        from repro_torch.kernels import _build

        print(f"[ssd backward passes] package {os.path.dirname(_build.__file__)}", flush=True)
        _build.build_all()
        chip_smoke.ssd_backward_passes(torch)
        return 0
    for src in sys.argv[1:] or [os.path.join(ROOT, "src")]:
        subprocess.run([sys.executable, __file__, "--one", src], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
