"""Percent of the dense bf16 peak: the story request's model operations (loops/story.py's request_flops) over its time, outside the profiled slice."""

from benchmark.readers import mfu as read  # noqa: F401
