"""Device operations launched inside one `unet` span of the program, mean over the profiled slice's UNet calls."""

from benchmark.readers import unet_kernels as read  # noqa: F401
