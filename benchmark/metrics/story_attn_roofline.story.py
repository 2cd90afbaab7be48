"""Percent: the least time of the profiled request's story_attention launch records (each row over its own keys and its group's bank; story_roofline.py) over the device time launched inside unet.story_attn."""

from benchmark.story_roofline import story_attn_roofline as read  # noqa: F401
