"""The profiled slice of a traced run and what is read from it.

``Slice`` runs its body under ``torch.profiler`` with device activity only
(host events would slow the host's launches, and the image cell is bound by
them) and records the shapes of every launch of the port's flash forward and
temporal-attention kernels, at the wrappers that launch them
(``ops/attention.py::_flash_cuda``, ``ops/temporal_attention.py::
temporal_attention_kernel``), where those exist. Read afterwards:

  busy_s      the union of the device operations' intervals;
  wall_s      the slice's host-clock length (it ends in a synchronise);
  kernel_s    device seconds of the operations whose name holds a string;
  device_ops  the device operations that took most time, by name;
  idle_gaps   the longest stretches with no device operation, each named by
              the device operation the host launched next ("before <name>"):
              what the host was preparing while the device waited.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import torch

NAME_CHARS = 120


def _patch(module_name: str, attr: str, record):
    """Wrap module.attr so that each call's (args, kwargs) goes to record
    first; -> an undo function, or None where the module or name is gone."""
    import importlib

    try:
        module = importlib.import_module(module_name)
    except ImportError:
        return None
    original = getattr(module, attr, None)
    if original is None:
        return None

    def wrapped(*a, **kw):
        record(a, kw)
        return original(*a, **kw)

    setattr(module, attr, wrapped)
    return lambda: setattr(module, attr, original)


class Slice:
    def __init__(self, device):
        self.device = torch.device(device)
        self.launches: Dict[str, List[dict]] = {"flash_fwd": [], "tattn_fwd": []}
        self.events: List[Tuple[str, float, float]] = []    # device operations, us
        self.wall_s = 0.0

    def _flash(self, a, kw):
        q, k = a[0], a[1]
        causal = a[3] if len(a) > 3 else kw.get("causal", True)
        B, T, Hq, D = q.shape
        self.launches["flash_fwd"].append(dict(B=B, T=T, S=k.shape[1], Hq=Hq, Hkv=k.shape[2],
                                               D=D, causal=bool(causal),
                                               elem_bytes=q.element_size()))

    def _tattn(self, a, kw):
        q, heads = a[0], a[3]
        layout = kw.get("layout", "bfpc")
        if layout == "bpfc":
            B, P, F, C = q.shape
        else:
            B, F, P, C = q.shape
        self.launches["tattn_fwd"].append(dict(B=B, F=F, P=P, C=C, heads=heads,
                                               elem_bytes=q.element_size()))

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._undo = [u for u in (
            _patch("spider_tpu_torch.ops.attention", "_flash_cuda", self._flash),
            _patch("spider_tpu_torch.ops.temporal_attention", "temporal_attention_kernel",
                   self._tattn)) if u is not None]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            acts = [ProfilerActivity.CUDA]
        else:
            acts = [ProfilerActivity.CPU]
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.wall_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        for undo in self._undo:
            undo()
        # device operations only: the ranges a record_function mirrors onto
        # the device's timeline are no operation
        self.events = [(e.name, float(e.time_range.start), float(e.time_range.end))
                       for e in self._prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False)]
        self._prof = None
        return False

    # ---------------------------------------------------------------- reading
    def device_intervals(self) -> List[Tuple[float, float]]:
        """Merged intervals (us) in which some device operation ran."""
        iv = sorted((s, e) for _, s, e in self.events if e > s)
        merged: List[List[float]] = []
        for s, e in iv:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.device_intervals()) / 1e6

    def kernel_s(self, substring: str) -> float:
        return sum(e - s for name, s, e in self.events if substring in name) / 1e6

    def device_ops(self, top: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for name, s, e in self.events:
            by[name] = by.get(name, 0.0) + (e - s) / 1e6
        rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[name[:NAME_CHARS], sec] for name, sec in rows]

    def idle_gaps(self, top: int = 10) -> List[list]:
        ops = sorted((s, e, name) for name, s, e in self.events if e > s)
        gaps, reach = [], None
        for s, e, name in ops:
            if reach is not None and s > reach:
                gaps.append((s - reach, name))
            reach = e if reach is None else max(reach, e)
        gaps.sort(key=lambda g: -g[0])
        return [[f"before {name}"[:NAME_CHARS], length / 1e6] for length, name in gaps[:top]]
