"""Parallel building blocks of the port (counterpart of spider_tpu/parallel)."""
