"""``prefill_useful_share.<serve|batch>``: prompt tokens over the positions the
window's prefill calls were handed (the batcher pads each to the cache), in %; counted
by the benchmark's wrapper on its own ``api.prefill``."""


def read(name, record):
    pos = record.counters.get("prefill_positions", 0)
    return 100.0 * record.counters["prefill_prompt_tokens"] / pos if pos else None
