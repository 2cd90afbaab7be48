"""Percent: the least time of the flash forward launches of the profiled request (their launch records, the story bank's included; roofline.py) over their device time."""

from benchmark.readers import flash_fwd_roofline as read  # noqa: F401
