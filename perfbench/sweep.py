"""Find a served cell's knee: the cell's traffic at several fixed rates, one window
each, in one process; per rate the tails, the tokens per second and the waiting queue
at the window's opening and close (a queue that grows over the window: above the
knee).

    python3 perfbench/sweep.py --workload granite-8b.serve.rag --rates 2,3,4 --seconds 30
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--lead-in", type=float, default=None, help="seconds (default: the cell's)")
    args = ap.parse_args()
    from perfbench import harness
    from perfbench.runners import serve
    cell, config = harness.cell_files(ROOT, args.workload)
    for rate in (float(r) for r in args.rates.split(",")):
        cell["arrivals"]["rate_per_s"] = rate
        if args.lead_in is not None:
            cell["arrivals"]["lead_in_s"] = args.lead_in
        out = serve.run(cell, config, args.seed, args.seconds, False, "cuda", time.perf_counter(),
                        check=False)
        e = out.end_to_end
        print(f"rate {rate} req/s: ttft_p90_ms {e['ttft_p90_ms']:.1f} tpot_p90_ms "
              f"{e['tpot_p90_ms']:.1f} output_tokens_per_s {e['output_tokens_per_s']:.1f} "
              f"waiting {e['waiting_at_open']} -> {e['waiting_at_close']} (most {e['waiting_max']}), "
              f"slots in use {e['active_mean']:.1f} of {cell['slots']}, due {out.attempted}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
    sys.exit(main())
