"""Device milliseconds a UNet call of the operations launched inside the program's unet.story_attn spans (the consistent self-attention: self call, bank call and merge), over the profiled request."""

from benchmark.story_roofline import story_attn_ms as read  # noqa: F401
