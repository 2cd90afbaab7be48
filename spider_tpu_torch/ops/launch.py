"""What every hand-written kernel's launch shares: its stream, the card's SM
count, per-stream scratch, the launch count and the scoped override of its
route.

Launch counts, safe under threads: every wrapper that launches a hand-written
kernel adds one to its ``launches`` attribute and to its route's entry of
``route_launches``. The stage orchestrator (serving/orchestrator.py) calls the
same wrappers from several threads at once; a bare ``+= 1`` on a function
attribute is a read-modify-write that can lose an update there, so every count
goes through ``count_launch``, under one lock. A wrapper that passes its
launch's shape has it kept, while spans are recorded, under the span open on
its thread (``common/profiler.py``).

Overrides: ``scoped_mode`` builds one named context manager and the getter of
its mode. A ContextVar holds the mode, so an override stays inside its scope
and its thread.
"""

from __future__ import annotations

import contextlib
import threading
from contextvars import ContextVar
from typing import Callable, Optional, Tuple

import torch

from spider_tpu_torch.common import profiler

_LOCK = threading.Lock()
_SMS = {}
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


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


def current_stream_handle(index: int) -> int:
    """The cudaStream_t of device `index`'s current stream, as
    ``torch.cuda.current_stream(index).cuda_stream`` gives it, without
    building a Stream object."""
    if _raw_stream is not None:
        return _raw_stream(index)
    return torch.cuda.current_stream(index).cuda_stream


def sm_count(index: int) -> int:
    n = _SMS.get(index)
    if n is None:
        n = _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return n


def stream_buffers(counters, scratch, device, stream: int, n_counters: int, n_floats: int):
    """The (counters, scratch) pair of (device, stream) from the two caches,
    grown to at least the sizes asked for. Launches on one stream run in
    order, so they can share both; the counters are zeroed when made, and
    each kernel leaves them zeroed."""
    key = (device.index, stream)
    c = counters.get(key)
    if c is None or c.numel() < n_counters:
        c = counters[key] = torch.zeros(max(n_counters, 4096), dtype=torch.int32, device=device)
    f = scratch.get(key)
    if f is None or f.numel() < n_floats:
        f = scratch[key] = torch.empty(n_floats, dtype=torch.float32, device=device)
    return c, f


def scoped_mode(name: str, modes: Tuple[str, ...],
                default: str) -> Tuple[Callable, Callable[[], str]]:
    """(config, get): ``with config(mode):`` sets the mode `name` to one of
    `modes` for the block, on this thread; ``get()`` reads it, `default`
    outside every such block. A mode not in `modes` raises ValueError."""
    var = ContextVar(name, default=default)

    @contextlib.contextmanager
    def config(mode: str):
        if mode not in modes:
            raise ValueError(f"{name} must be one of {modes}, got {mode!r}")
        tok = var.set(mode)
        try:
            yield
        finally:
            var.reset(tok)

    return config, var.get
