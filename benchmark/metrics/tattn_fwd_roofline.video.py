"""Percent: the least time of the temporal-attention launches in the profiled slice (roofline.py) over their device time."""

from benchmark.readers import tattn_fwd_roofline as read  # noqa: F401
