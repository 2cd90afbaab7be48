"""Percent of the profiled slice's wall time with the device idle while the host was inside a `unet` span of the program."""

from benchmark.readers import unet_launch_idle as read  # noqa: F401
