"""Milliseconds of a span's CFG DDIM loop (the pipeline's _denoise_fn run), ended in a synchronise."""

from benchmark.readers import denoise_ms as read  # noqa: F401
