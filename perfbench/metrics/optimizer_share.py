"""``optimizer_share.train``: the device seconds of the program's ``train.clip`` and
``train.adamw`` spans over those of its ``train.step``, in %, from
``repro_torch.core.tracing.device_seconds()``. The program times its stages only while
a profiler records, and the counts add up over every profiled region of the process: in
a run of the benchmark that is the traced window alone. Nothing where the program counts
no such stage, a program without the counter included."""

STEP = "repro_torch.train.step"


def device_seconds() -> dict:
    """The program's device seconds by span (empty where the program has none)."""
    from repro_torch.core import tracing
    counts = getattr(tracing, "device_seconds", None)
    return counts() if counts is not None else {}


def share(names) -> float:
    """The named spans' device seconds over the training step's, in % (None where the
    step or a name was not counted)."""
    seconds = device_seconds()
    if seconds.get(STEP, 0.0) <= 0.0 or any(n not in seconds for n in names):
        return None
    return 100.0 * sum(seconds[n] for n in names) / seconds[STEP]


def read(name, record):
    return share(("repro_torch.train.clip", "repro_torch.train.adamw"))
