"""The readings the limits of ``correct`` are set from, on the card at a cell's own
size: per seed, the program's numbers, the control's (the plain reference in float8
e4m3 put in the program's place) and, for a training cell, the program with half of
each batch left out (the mean taken over the rest). The benchmark's own runs do not
run this.

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13 [--seconds 15]

A served cell runs a short window at the cell's load; the control reads, at each
position of the same prompts and served tokens, the reference's gap of the token the
float8 reference puts first. A training cell needs no window. Each row is judged
under the cell's own limits, as a run of the benchmark judges it: ``correct True``
for the program, ``correct False`` for the control and the fault.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def half_batch(step):
    """The fault: each step sees the first half of its rows only."""
    return lambda state, batch: step(state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    args = ap.parse_args()
    import torch
    from perfbench import harness
    from perfbench.reference import for_config
    cell, config = harness.cell_files(ROOT, args.workload)
    for_config(config).no_tf32()
    for seed in (int(s) for s in args.seeds.split(",")):
        if cell["runner"] == "serve":
            from perfbench.runners import serve
            out = serve.run(cell, config, seed, args.seconds, False, "cuda", time.perf_counter())
            ctrl = max(g.max() for g in serve.token_gaps(config, seed, out.served, "cuda",
                                                         quant="fp8"))
            limit = cell["check"]["limits"]["widest_logit_gap"]
            rows = {"program": out.checks,
                    "control (fp8)": [harness.Check("widest_logit_gap", float(ctrl), limit)]}
            print(f"seed {seed}: served tokens compared {sum(len(g) for _, g in out.served)}")
        else:
            from perfbench.runners import train
            t = time.perf_counter()
            want = train.reference_steps(cell, config, seed, "cuda")
            t_ref = time.perf_counter() - t
            got = {"program": train.program_steps(cell, config, seed, 1.0, False, "cuda", t)[2],
                   "control (fp8)": train.reference_steps(cell, config, seed, "cuda", quant="fp8"),
                   "half batch": train.program_steps(cell, config, seed, 1.0, False, "cuda", t,
                                                     step_hook=half_batch)[2]}
            rows = {what: train.compare(cell, g, want) for what, g in got.items()}
            print(f"seed {seed}: reference losses {want['loss']}, {t_ref:.1f} s; losses "
                  + "; ".join(f"{what} {g['loss']}" for what, g in got.items()))
        for what, checks in rows.items():
            # the control and a fault have to come out not correct, the program correct
            print(f"seed {seed}: {what}: correct {all(c.ok for c in checks)}: "
                  + "; ".join(harness.check_lines(checks)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
    sys.exit(main())
