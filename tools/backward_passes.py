#!/usr/bin/env python
"""The backward kernels' device ms by launch at the training shapes, from the profiler's
events (``chip_smoke.BACKWARD_PASSES``: ``ssd`` bf16 and float32, ``flash_attention`` and
``rmsnorm`` bf16), for the package under each source directory given: this checkout's
``src`` when none is. Each directory's kernels are built from its own sources (into
``build/`` beside it) and timed in a process of its own, so a parent commit unpacked
into a gitignored directory can be timed in the same run as this one, for the kernels
both trees have. Needs a CUDA card and ``nvcc``.

Usage: python tools/backward_passes.py [--kernels ssd,flash_attention,rmsnorm] [SRC ...]
(from the repo root; every kernel when ``--kernels`` is not given)
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--one":
        src, kernels = sys.argv[2], sys.argv[3].split(",")
        sys.path[:0] = [os.path.abspath(src), ROOT]
        import torch

        import chip_smoke
        from repro_torch.kernels import _build

        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
        print(f"[backward passes] package {os.path.dirname(_build.__file__)} on {card}",
              flush=True)
        _build.build_all()
        for name in kernels:
            chip_smoke.BACKWARD_PASSES[name](torch)
        return 0
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels", default="ssd,flash_attention,rmsnorm")
    parser.add_argument("src", nargs="*", default=[os.path.join(ROOT, "src")])
    args = parser.parse_args()
    for src in args.src:
        subprocess.run([sys.executable, __file__, "--one", src, args.kernels], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
