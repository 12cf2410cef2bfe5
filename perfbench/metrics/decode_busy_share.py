"""``decode_busy_share.<serve|batch>``: within the program's ``repro_torch.batcher.decode``
spans (a decode step as the batcher's host sees it: from the tokens' copy to the card
until the host holds the next tokens), the share of time in which a kernel ran on the
card, in %: the union of the traced window's kernel intervals clipped to the spans, over
the spans' length. Nothing where the program records no such span.

In the traced window a decode span also holds the benchmark's own counting ops
(``perfbench/tracing.py:KernelCalls``) and their first loading, so it reads lower there
than the program alone would."""
from perfbench import stats

SPAN = "repro_torch.batcher.decode"


def read(name, record):
    tr = record.device
    spans = [(s, e) for n, s, e in (tr.host if tr is not None else []) if n == SPAN and e > s]
    if not spans:
        return None
    kernels = [(s, e) for _, s, e in tr.kernels]
    lo, hi = min(s for s, _ in spans), max(e for _, e in spans)
    length = stats.union_length(spans, lo, hi)
    # kernels inside the spans: |K & S| = |K| + |S| - |K | S|
    covered = stats.union_length(kernels, lo, hi) + length - stats.union_length(kernels + spans, lo, hi)
    return 100.0 * covered / length
