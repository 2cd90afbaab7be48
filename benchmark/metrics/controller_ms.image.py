"""Milliseconds of a request's host time outside its decoder calls (models/spider_decoder.py): tag parsing and dispatch."""

from benchmark.readers import controller_ms as read  # noqa: F401
