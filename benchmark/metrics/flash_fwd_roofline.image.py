"""Percent: the least time of the flash forward launches in the profiled slice (roofline.py) over their device time."""

from benchmark.readers import flash_fwd_roofline as read  # noqa: F401
