"""``device_idle_outside_program.<serve|batch|train>``: the share of the traced window
in which no kernel ran on the card and no top-level span of the program was open
(``repro_torch.batcher.step``, ``repro_torch.train.step``), in %: the idle time that the
benchmark's own loop leaves, not the program. Nothing where the program records no such
span."""
from perfbench import stats

TOP = ("repro_torch.batcher.step", "repro_torch.train.step")


def read(name, record):
    tr = record.device
    if tr is None or tr.end_ns <= tr.start_ns:
        return None
    spans = [(s, e) for n, s, e in tr.host if n in TOP]
    if not spans:
        return None
    covered = stats.union_length([(s, e) for _, s, e in tr.kernels] + spans, tr.start_ns, tr.end_ns)
    return 100.0 * (1.0 - covered / (tr.end_ns - tr.start_ns))
