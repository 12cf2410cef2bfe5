"""Run one cell of the benchmark once, on the machine this starts on.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is ``perfbench/workloads/<cell>.json``; its
metrics are those ``BENCHMARK.json`` lists for it (end-to-end with ``--trace 0``,
per-layer with ``--trace 1``). The last line of standard output is the result's
JSON object; the numbers compared, each beside its limit, are the last lines of
standard error and the result's last key. Without enough CUDA cards, or with a
module of JAX or of the JAX package loaded once the window has closed, it prints no
result and exits with a code other than 0.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    from perfbench import harness
    t_process = harness.process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    cell, config = harness.cell_files(ROOT, args.workload)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.cuda.set_device(0)
    from perfbench.reference import for_config
    for_config(config).no_tf32()
    runner = __import__(f"perfbench.runners.{cell['runner']}", fromlist=["run"])
    outcome = runner.run(cell, config, args.seed, args.seconds, bool(args.trace), "cuda",
                         t_process)

    bad = harness.forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": entry["chips"],
              "memory_peak_bytes": outcome.memory_peak_bytes}
    tr = outcome.record.device
    if args.trace and tr is not None:
        device["busy_s"] = tr.busy_s()
        device["window_s"] = tr.window_s
    line, checks = harness.result_line(outcome, harness.metrics_for(bench, args.workload,
                                                                    bool(args.trace)),
                                       bool(args.trace), device)
    sys.stdout.flush()
    for c in checks:
        print(c, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]   # not this folder: its names are not the stdlib's
    cache = ROOT / "build" / "perfbench-cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(cache / sub)
    sys.exit(main())
