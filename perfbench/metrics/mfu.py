"""``mfu.<serve|batch|train>``: model FLOPs (``perfbench.costs``: no padding, no
recompute) over time and the bf16 peak, in %, over the untraced part of the window.

* serve: the prompt tokens prefilled, over the time spent in prefill calls;
* batch: the prompt and generated tokens, over that part of the window;
* train: the steps that ran there, over their time."""
from perfbench.costs import PEAK_FLOPS


def read(name, record):
    kind = name.split(".")[1]
    c, spans = record.counters, record.spans
    if kind == "serve":
        t = sum(e - s for s, e in spans.get("prefill", []))
        flops = c.get("prefill_flops", 0.0)
    elif kind == "batch":
        t = record.span_window[1] - record.span_window[0]
        flops = c.get("prefill_flops", 0.0) + c.get("decode_flops", 0.0)
    else:
        steps = spans.get("train_step", [])
        t = steps[-1][1] - steps[0][0] if steps else 0.0
        flops = c.get("train_step_flops", 0.0) * len(steps)
    return 100.0 * flops / (t * PEAK_FLOPS["bfloat16"]) if t > 0 and flops > 0 else None
