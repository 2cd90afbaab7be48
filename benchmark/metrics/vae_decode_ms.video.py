"""Milliseconds of a span's decode (the pipeline's _decode_latents), to the copy on the host."""

from benchmark.readers import vae_decode_ms as read  # noqa: F401
