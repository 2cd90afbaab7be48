"""Percent: the least time of the GroupNorm launches of the profiled request (their launch records; roofline.py: x read once, y written once) over the device time of csrc/group_norm.cu's stats and apply kernels."""

from benchmark.readers import group_norm_roofline as read  # noqa: F401
