"""Profiling (counterpart of spider_tpu/common/profiler.py): torch.profiler
traces of the host and the CUDA device, device-memory stats and host-side
step timers.

Usage:
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
import logging
import os
import time
from typing import Dict, List

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


def annotate(name: str):
    """Named trace region (a row of the profiler's timeline)."""
    return torch.profiler.record_function(name)
