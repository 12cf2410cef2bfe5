"""``tpot_p90_ms.serve``: the 90th percentile, over every request with two or more
tokens in the untraced part of the window, of the time from its first to its last token
there over its tokens after the first, in ms: the time per output token that the
batcher's decode steps and the prefills between them give a request."""
from perfbench.stats import percentile


def read(name, record):
    tpots = record.counters.get("tpots")
    return 1e3 * percentile(tpots, 90) if tpots else None
