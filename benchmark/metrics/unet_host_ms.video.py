"""Milliseconds of host time of one UNet call: the mean length of the program's `unet` spans over the traced requests outside the profiled slice."""

from benchmark.readers import unet_host_ms as read  # noqa: F401
