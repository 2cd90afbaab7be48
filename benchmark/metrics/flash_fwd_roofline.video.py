"""Percent: the least time of the flash forward launches of the profiled request (their launch records; roofline.py) over their device time."""

from benchmark.readers import flash_fwd_roofline as read  # noqa: F401
