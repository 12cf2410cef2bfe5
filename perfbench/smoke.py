"""A benchmark cell at a size the CPU runs in a second or two, for the tests."""
import json
from pathlib import Path

from perfbench.reference import for_config

ROOT = Path(__file__).resolve().parent.parent


def smoke_config(name: str) -> dict:
    """A configuration file of the benchmark at the smoke size of its family, which its
    reference module's ``SMOKE`` gives."""
    c = json.loads((ROOT / "perfbench" / "configs" / f"{name}.json").read_text())
    ref = for_config(c)
    c.update(ref.SMOKE[ref.Arch.from_config(c).family])
    return c


def smoke_cell(name: str) -> dict:
    """A cell's file at a size the CPU runs in a second or two."""
    c = json.loads((ROOT / "perfbench" / "workloads" / f"{name}.json").read_text())
    c["trace_seconds"] = 0.3
    if c["runner"] == "serve":
        c.update(slots=4, cache_len=96)
        c["arrivals"]["lead_in_s"] = 0.3
        if c["arrivals"]["loop"] == "open":
            c["arrivals"]["rate_per_s"] = 8.0
        else:
            c["arrivals"].update(clients=6, pool=16)
        c["prompt_tokens"].update(median=30, min=8, max=70)
        c["output_tokens"].update(median=12, min=4, max=24)
    else:
        c.update(batch=4, seq=64, micro_batches=2)
        c["check"]["steps"] = 2
    return c
