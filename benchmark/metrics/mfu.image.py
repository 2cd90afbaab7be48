"""Percent of the dense bf16 peak: the request's model operations (flops.py) over its time, outside the profiled slice."""

from benchmark.readers import mfu as read  # noqa: F401
