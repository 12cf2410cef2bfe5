"""``moe_dispatch_share.train``: the device seconds of the MoE layer's ``moe.route``,
``moe.dispatch`` and ``moe.combine`` stages, each forward and ``.backward``, over those of
the program's ``train.step``, in % (``optimizer_share.py`` says where they come from).
Nothing where the program counts no such stage.

A stage's device seconds run from one CUDA event to the next, so a host stall inside a
stage counts as that stage's: a pass of Python's collector that lands in ``moe.route``
(0.1-0.25 s, about once a traced window of olmoe's training cell) adds 2-4 points. Read
it beside the ``repro_torch.python.gc`` spans, or once the training runner keeps the
collector out of the window."""
from perfbench.metrics.optimizer_share import share


def read(name, record):
    return share([f"repro_torch.moe.{s}{b}" for s in ("route", "dispatch", "combine")
                  for b in ("", ".backward")])
