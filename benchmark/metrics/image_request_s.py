"""Seconds an image request takes: the window over the requests completed."""

from benchmark.readers import mean_request_s as read  # noqa: F401
