"""``ssd_backward``'s share of its roofline, read as ``roofline.py`` says (its cost and peak from
``perfbench/kernels/ssd_backward.py``)."""
from perfbench.metrics.roofline import read  # noqa: F401
