"""``queue_wait_p90_ms.serve``: the 90th percentile over the requests due in the
untraced part of the window of the time from a request's due time to the start of its
prefill call (admission is FIFO, so the calls match the requests in order), in ms."""
from perfbench.stats import percentile


def read(name, record):
    waits = record.counters.get("queue_waits")
    return 1e3 * percentile(waits, 90) if waits else None
