"""``prefill_ms.<serve|batch>``: the mean host time of a ``prefill`` call up to the
device's synchronize (the benchmark's span), in ms."""


def read(name, record):
    spans = record.spans.get("prefill")
    return 1e3 * sum(e - s for s, e in spans) / len(spans) if spans else None
