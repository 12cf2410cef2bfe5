"""A benchmark cell at a size the CPU runs in a second or two, for the tests."""
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

SMOKE = {
    "dense": dict(num_hidden_layers=2, hidden_size=64, intermediate_size=160, num_attention_heads=8,
                  num_key_value_heads=2, head_dim=8, vocab_size=256),
    "moe": dict(num_hidden_layers=2, hidden_size=64, intermediate_size=32, num_attention_heads=4,
                num_key_value_heads=4, head_dim=16, vocab_size=256, num_experts=8,
                num_experts_per_tok=2),
}


def smoke_config(name: str) -> dict:
    """A configuration file of the benchmark at the smoke size of its family."""
    c = json.loads((ROOT / "perfbench" / "configs" / f"{name}.json").read_text())
    c.update(SMOKE["moe" if c.get("num_experts") else "dense"])
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
