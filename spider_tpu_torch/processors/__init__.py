"""Preprocessing pipelines (numpy, host-side): copies of the framework-free
``text``, ``vision``, ``video`` and ``audio`` modules of
spider_tpu/processors/."""
