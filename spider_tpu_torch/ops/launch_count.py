"""Launch counts of the kernel wrappers, safe under threads.

Every wrapper that launches a hand-written kernel adds one to its
``launches`` attribute and to its route's entry of ``route_launches``. The
stage orchestrator (serving/orchestrator.py) calls the same wrappers from
several threads at once; a bare ``+= 1`` on a function attribute is a
read-modify-write that can lose an update there, so every count goes
through ``count_launch``, under one lock. A wrapper that passes its
launch's shape has it kept, while spans are recorded, under the span open on
its thread (``common/profiler.py``).
"""

from __future__ import annotations

import threading
from typing import Optional

from spider_tpu_torch.common import profiler

_LOCK = threading.Lock()


def count_launch(wrapper, route: str, shape: Optional[dict] = None) -> None:
    """Add one launch of `wrapper`'s kernel on `route`; with `shape`, keep
    the launch among the recorded ones (``profiler.record_launch``)."""
    with _LOCK:
        wrapper.launches += 1
        wrapper.route_launches[route] += 1
    if shape is not None:
        profiler.record_launch(wrapper.__name__, route, shape)


def reset_launches(wrapper) -> None:
    """Set `wrapper`'s count and each of its routes' counts to 0."""
    with _LOCK:
        wrapper.launches = 0
        wrapper.route_launches = dict.fromkeys(wrapper.route_launches, 0)
