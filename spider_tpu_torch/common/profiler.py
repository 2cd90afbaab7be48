"""Profiling (counterpart of spider_tpu/common/profiler.py): the program's
spans and launch records, torch.profiler traces of the host and the CUDA
device, device-memory stats and host-side step timers.

Usage:
    with recording():
        with span("pipeline.step", i=3):
            run_step()
    rec = drain()        # the spans and launches recorded, and the clock anchor

    with trace("/tmp/trace") as prof:
        run_steps()
    prof.trace_path      # the Chrome trace written (chrome://tracing, Perfetto)

    timer = StepTimer()
    with timer.step():
        train_step(...)
    timer.summary()  # p50/p90 step time, steps/s
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True):
    """torch.profiler over the block, CPU activity and, where CUDA is
    available, the device's; on a clean exit the Chrome trace is written to
    ``<log_dir>/trace-<pid>-<ns>.json`` and its path set as the profiler's
    ``trace_path``. Yields the profiler (None when not enabled)."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.trace_path = os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)
    logging.info("profile trace written to %s", prof.trace_path)


def device_memory_stats() -> Dict[str, float]:
    """GB allocated on each CUDA device ({} without one), from
    ``torch.cuda.memory_stats``."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[str(i)] = stats.get("allocated_bytes.all.current", 0) / 1e9
    return out


class StepTimer:
    """Host-clock step times over a sliding window. A step that launches
    device work is timed to its end only if it synchronises."""

    def __init__(self, window: int = 200):
        self.times: List[float] = []
        self.window = window

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        self.times.append(time.perf_counter() - t0)
        if len(self.times) > self.window:
            self.times.pop(0)

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return dict(p50=float(np.percentile(arr, 50)),
                    p90=float(np.percentile(arr, 90)),
                    mean=float(arr.mean()),
                    steps_per_s=float(1.0 / max(arr.mean(), 1e-9)))


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------
#
# A span is one named interval of host time on ``time.perf_counter_ns``,
# with its own id, its parent's id and the id of its root (a request's spans
# share their root's id). Recording is off unless a ``recording()`` block is
# open: then ``span()`` is one test of ``_ON`` and returns the shared no-op.
# Parents are kept per thread (and per asyncio task) in a ContextVar, so a
# span opened on one thread never hangs under another thread's span.
# The anchor pairs a ``perf_counter_ns`` reading with a ``time_ns`` reading
# taken at once, which puts the spans on the clock torch.profiler gives its
# events on (nanoseconds since the epoch, host and device alike).

_ON = False
_LOCK = threading.Lock()
_IDS = itertools.count(1)
_CURRENT: contextvars.ContextVar[Optional["SpanRecord"]] = contextvars.ContextVar(
    "spider_span", default=None)


@dataclasses.dataclass
class SpanRecord:
    """One span: start and end on ``perf_counter_ns``; ``root`` is the id of
    the outermost span it was opened under (its own id at the top)."""
    name: str
    id: int
    parent: Optional[int]
    root: int
    thread: int
    attrs: dict
    start_ns: int = 0
    end_ns: int = 0


@dataclasses.dataclass
class LaunchRecord:
    """One launch of a hand-written kernel: its wrapper's name, route and
    shape, the innermost span open when it was launched, and when."""
    kernel: str
    route: str
    shape: dict
    span: Optional[int]
    t_ns: int


@dataclasses.dataclass
class Recording:
    """What ``drain`` takes out: the spans closed and the launches made since
    the last drain, and the clock anchor (perf_counter_ns, time_ns)."""
    spans: List[SpanRecord]
    launches: List[LaunchRecord]
    anchor: Tuple[int, int]

    def wall_ns(self, perf_ns: int) -> int:
        """A ``perf_counter_ns`` reading on the ``time_ns`` clock."""
        return self.anchor[1] + (perf_ns - self.anchor[0])


_SPANS: List[SpanRecord] = []
_LAUNCHES: List[LaunchRecord] = []
_ANCHOR: Tuple[int, int] = (0, 0)


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "attrs", "rec", "token", "rf")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self) -> SpanRecord:
        parent = _CURRENT.get()
        with _LOCK:
            sid = next(_IDS)
        self.rec = SpanRecord(self.name, sid, parent.id if parent else None,
                              parent.root if parent else sid, threading.get_ident(), self.attrs)
        self.token = _CURRENT.set(self.rec)
        # under an active torch.profiler the span is also a row of its trace
        self.rf = (torch.profiler.record_function(self.rec.name).__enter__()
                   if torch.autograd._profiler_enabled() else None)
        self.rec.start_ns = time.perf_counter_ns()
        return self.rec

    def __exit__(self, *exc):
        self.rec.end_ns = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _CURRENT.reset(self.token)
        with _LOCK:
            _SPANS.append(self.rec)
        return False


def span(name: str, **attrs):
    """A context manager recording `name` over its block, with `attrs`,
    under the innermost span open on this thread; the shared no-op
    ``NO_SPAN`` while recording is off."""
    if not _ON:
        return NO_SPAN
    return _Span(name, attrs)


def recording_on() -> bool:
    """Whether spans and launches are being recorded: a wrapper builds a
    launch's shape for ``record_launch`` only then."""
    return _ON


def record_launch(kernel: str, route: str, shape: dict) -> None:
    """Keep one launch under the innermost open span (while recording)."""
    if not _ON:
        return
    cur = _CURRENT.get()
    rec = LaunchRecord(kernel, route, shape, cur.id if cur else None, time.perf_counter_ns())
    with _LOCK:
        _LAUNCHES.append(rec)


@contextlib.contextmanager
def recording():
    """Record spans and launches over the block. The clock anchor is taken
    when recording starts; what was recorded stays until ``drain``."""
    global _ON, _ANCHOR
    was = _ON
    if not was:
        _ANCHOR = (time.perf_counter_ns(), time.time_ns())
    _ON = True
    try:
        yield
    finally:
        _ON = was


def drain() -> Recording:
    """Take the spans closed and the launches made so far out of memory."""
    global _SPANS, _LAUNCHES
    with _LOCK:
        spans, launches, _SPANS, _LAUNCHES = _SPANS, _LAUNCHES, [], []
    return Recording(spans, launches, _ANCHOR)
