"""The 90th percentile of the window's image request latencies, in seconds."""

from benchmark.readers import p90_request_s as read  # noqa: F401
