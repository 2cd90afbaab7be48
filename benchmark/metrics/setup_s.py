"""Seconds from the process's start to the window's start: building, filling the weights, the warm-up request (and, in a fresh checkout, nvcc)."""

from benchmark.readers import setup_s as read  # noqa: F401
