"""Percent of the profiled slice's wall time with no device operation running."""

from benchmark.readers import device_idle as read  # noqa: F401
