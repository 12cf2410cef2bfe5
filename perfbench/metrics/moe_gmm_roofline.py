"""``moe_gmm``'s share of its roofline, read as ``roofline.py`` says."""
from perfbench.metrics.roofline import read  # noqa: F401
