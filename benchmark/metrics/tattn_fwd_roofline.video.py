"""Percent: the least time of the temporal-attention launches of the profiled request (their launch records; roofline.py) over their device time."""

from benchmark.readers import tattn_fwd_roofline as read  # noqa: F401
