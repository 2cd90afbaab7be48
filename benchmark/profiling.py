"""The profiled slice of a traced run and what is read from it, alone or
beside the program's spans (``spider_tpu_torch/common/profiler.py``).

``Slice`` runs its body under ``torch.profiler`` with device activity only
(host events would slow the host's launches, and the image cell is bound by
them). It keeps ``ops`` [(name, start_ns, end_ns, launch_ns or None)]: each
device operation on the profiler's clock (nanoseconds since the epoch, the
clock of ``time.time_ns``) with the host time of the CUDA call that launched
it (the runtime event of the same correlation id); and ``collections``
[(start_ns, end_ns)] on ``perf_counter_ns``: the garbage collector's runs
inside the slice (``gc.callbacks``). A full collection stalls the host for
0.05-0.5 s (an H100 run), and the device then waits: that is the program's
cost, and is kept, under a name of its own. Read afterwards:

  busy_s      the union of the device operations' intervals;
  wall_s      the slice's host-clock length (it ends in a synchronise);
  kernel_s    device seconds of the operations whose name holds a string;
  device_ops  the device operations that took most time, by name;
  idle_gaps   the longest stretches with no device operation, each named by
              what the host did most of it (``GC`` within a collection, else
              the innermost program span open) and the device operation the
              host launched next ("<span>: before <name>"): what the host was
              doing while the device waited.

``Profiled`` puts the profiled request's spans (a ``Recorded``: the
``Recording`` drained after it) beside its slice: each operation goes to the
innermost span open on the host when it was launched, each idle stretch to
``GC`` while a collection ran and otherwise to the spans open meanwhile
(``idle_by_span``; the readers' ``idle_by`` keeps the spans alone). A span's
``perf_counter_ns`` readings go to the profiler's clock through the
recording's anchor (``Recorded.wall_ns``).
"""

from __future__ import annotations

import bisect
import gc
import time
from collections import defaultdict, namedtuple
from typing import Dict, List, Optional, Tuple

import torch

NAME_CHARS = 120
OUTSIDE = "outside any span"
GC = "gc"

Op = Tuple[str, int, int, Optional[int]]


class Slice:
    def __init__(self, device):
        self.device = torch.device(device)
        self.ops: List[Op] = []
        self.collections: List[Tuple[int, int]] = []
        self.wall_s = 0.0
        self.t0_ns = self.t1_ns = 0          # the slice's ends on perf_counter_ns
        self._gc_start: Optional[int] = None

    def _collection(self, phase: str, info: dict) -> None:
        t = time.perf_counter_ns()
        if phase == "start":
            self._gc_start = t
        elif self._gc_start is not None:
            self.collections.append((self._gc_start, t))
            self._gc_start = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            acts = [ProfilerActivity.CUDA]
        else:
            acts = [ProfilerActivity.CPU]
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        gc.callbacks.append(self._collection)
        self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t1_ns = time.perf_counter_ns()
        gc.callbacks.remove(self._collection)
        self.wall_s = (self.t1_ns - self.t0_ns) / 1e9
        prof, self._prof = self._prof, None
        prof.__exit__(*exc)
        device = torch.autograd.DeviceType.CUDA if self.device.type == "cuda" else None
        launch: Dict[int, int] = {}
        ops = []
        # device operations only: the ranges a record_function mirrors onto
        # the device's timeline are no operation
        for e in prof.profiler.kineto_results.events():
            if e.is_user_annotation():
                continue
            if e.device_type() == device:
                ops.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                            e.correlation_id()))
            elif e.correlation_id():
                c = e.correlation_id()
                launch[c] = min(launch.get(c, e.start_ns()), e.start_ns())
        self.ops = [(name, s, e, launch.get(c)) for name, s, e, c in ops]
        return False

    # ---------------------------------------------------------------- reading
    def device_intervals(self) -> List[Tuple[int, int]]:
        """Merged intervals (ns) in which some device operation ran."""
        merged: List[List[int]] = []
        for s, e in sorted((s, e) for _, s, e, _l in self.ops if e > s):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.device_intervals()) / 1e9

    def kernel_s(self, *substrings: str) -> float:
        """Device seconds of the operations whose name holds any of
        `substrings`."""
        return sum(e - s for name, s, e, _l in self.ops
                   if any(sub in name for sub in substrings)) / 1e9

    def device_ops(self, top: int = 10) -> List[list]:
        by: Dict[str, float] = defaultdict(float)
        for name, s, e, _l in self.ops:
            by[name] += (e - s) / 1e9
        rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[name[:NAME_CHARS], sec] for name, sec in rows]

    def idle_gaps(self, profiled: Optional["Profiled"] = None, top: int = 10) -> List[list]:
        """The `top` longest stretches between device operations, each named
        by what `profiled` finds the host doing most of it (``OUTSIDE``
        without it) and the operation that ends it."""
        gaps, reach = [], None
        for s, e, name in sorted((s, e, name) for name, s, e, _l in self.ops if e > s):
            if reach is not None and s > reach:
                gaps.append((s - reach, reach, name))
            reach = e if reach is None else max(reach, e)
        gaps.sort(key=lambda g: -g[0])
        out = []
        for length, start, name in gaps[:top]:
            where = profiled.most_open(start, start + length) if profiled else OUTSIDE
            out.append([f"{where}: before {name}"[:NAME_CHARS], length / 1e9])
        return out


# ------------------------------------------------------- the program's spans
Segment = Tuple[int, int, Optional[int]]


class Recorded(namedtuple("Recorded", "spans launches anchor")):
    """A drained ``Recording`` kept in forms the collector leaves alone:
    ``spans`` [(name, id, parent, start_ns, end_ns)] on ``perf_counter_ns``,
    plain tuples of numbers and strings, which it stops tracking; and
    ``launches`` {kernel wrapper: [shape]}, the wrappers' dicts of numbers,
    which it never tracks. So a window's hundreds of thousands of records add
    nothing to the host's full collections; kept as the program's objects,
    they made each of a traced window's six to eight full collections
    longer, up to 0.47 s (an H100 run)."""

    def wall_ns(self, perf_ns: int) -> int:
        """A ``perf_counter_ns`` reading on the ``time_ns`` clock."""
        return self.anchor[1] + (perf_ns - self.anchor[0])


def compact(rec) -> Recorded:
    """A drained ``Recording`` as a ``Recorded``."""
    launches: Dict[str, List[dict]] = defaultdict(list)
    for r in rec.launches:
        launches[r.kernel].append(r.shape)
    return Recorded([(s.name, s.id, s.parent, s.start_ns, s.end_ns) for s in rec.spans],
                    dict(launches), tuple(rec.anchor))


def on_clock(rec: Recorded) -> Dict[int, tuple]:
    """{id: (name, parent, start_ns, end_ns)} of a recording's spans on the
    profiler's clock."""
    return {sid: (name, parent, rec.wall_ns(s), rec.wall_ns(e))
            for name, sid, parent, s, e in rec.spans}


def innermost(spans: Dict[int, tuple]) -> List[Segment]:
    """The host's time cut into segments (start, end, span id), each id the
    innermost span open then; nested spans on one thread."""
    kids = defaultdict(list)
    for sid, (_, parent, s, _e) in spans.items():
        kids[parent if parent in spans else None].append((s, sid))
    out: List[Segment] = []

    def walk(sid):
        _, _, s, e = spans[sid]
        t = s
        for cs, cid in sorted(kids[sid]):
            if cs > t:
                out.append((t, cs, sid))
            walk(cid)
            t = max(t, spans[cid][3])
        if e > t:
            out.append((t, e, sid))

    for _, sid in sorted(kids[None]):
        walk(sid)
    return sorted(out, key=lambda seg: seg[0])


def cut(intervals, pauses) -> Tuple[List[Tuple[int, int]], List[Tuple[int, int]]]:
    """`intervals` cut into (the parts inside some of `pauses`, the rest);
    `pauses` sorted and apart."""
    inside, rest = [], []
    for a, b in intervals:
        t = a
        for s, e in pauses:
            if e <= t or s >= b:
                continue
            if s > t:
                rest.append((t, s))
            inside.append((max(s, t), min(e, b)))
            t = min(e, b)
        if b > t:
            rest.append((t, b))
    return inside, rest


def idle_intervals(ops: List[Op], t0: int, t1: int) -> List[Tuple[int, int]]:
    """The stretches of [t0, t1] with no device operation running."""
    out, reach = [], t0
    for s, e in sorted((s, e) for _, s, e, _l in ops if e > s):
        if s > reach:
            out.append((reach, min(s, t1)))
        reach = max(reach, e)
        if reach >= t1:
            break
    if reach < t1:
        out.append((reach, t1))
    return [(s, e) for s, e in out if e > s]


class Timeline:
    """Which span the host was innermost in, at any time: ``innermost``'s
    segments, searched by their starts."""

    def __init__(self, spans: Dict[int, tuple]):
        self.segments = innermost(spans)
        self.starts = [seg[0] for seg in self.segments]

    def at(self, t: Optional[int]) -> Optional[int]:
        """The innermost span open at `t` (None: none, or no time)."""
        if t is None:
            return None
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t < self.segments[i][1]:
            return self.segments[i][2]
        return None

    def overlap(self, intervals) -> Dict[Optional[int], int]:
        """Nanoseconds of `intervals` under each innermost span (None: under
        no span)."""
        out: Dict[Optional[int], int] = defaultdict(int)
        for a, b in intervals:
            covered = 0
            i = max(0, bisect.bisect_right(self.starts, a) - 1)
            while i < len(self.segments) and self.segments[i][0] < b:
                s, e, sid = self.segments[i]
                n = min(b, e) - max(a, s)
                if n > 0:
                    out[sid] += n
                    covered += n
                i += 1
            if b - a > covered:
                out[None] += b - a - covered
        return out


def under(spans: Dict[int, tuple], name: str) -> Dict[int, Optional[int]]:
    """{span id: id of the nearest span named `name` at or above it, or
    None}."""
    memo: Dict[Optional[int], Optional[int]] = {None: None}

    def up(sid):
        if sid not in memo:
            n, parent, _, _ = spans[sid]
            memo[sid] = sid if n == name else up(parent if parent in spans else None)
        return memo[sid]

    return {sid: up(sid) for sid in spans}


class Profiled:
    """The profiled request's spans beside its slice: ``spans`` on the
    profiler's clock, their ``timeline``, each device operation's launching
    span (``launched_in``), the slice's ``idle`` stretches and its
    collections (``pauses``) on the same clock."""

    def __init__(self, rec: Recorded, sl: Slice):
        self.rec, self.slice = rec, sl
        self.spans = on_clock(rec)
        self.timeline = Timeline(self.spans)
        self.launched_in = [self.timeline.at(t) for *_x, t in sl.ops]
        self.idle = idle_intervals(sl.ops, rec.wall_ns(sl.t0_ns), rec.wall_ns(sl.t1_ns))
        self.pauses = sorted((rec.wall_ns(s), rec.wall_ns(e)) for s, e in sl.collections)

    def name(self, sid: Optional[int]) -> str:
        return OUTSIDE if sid is None else self.spans[sid][0]

    def idle_by(self) -> Dict[Optional[int], int]:
        """Idle nanoseconds under each innermost span, collections and all."""
        return self.timeline.overlap(self.idle)

    def doing(self, intervals) -> Dict[str, int]:
        """Nanoseconds of `intervals` by what the host did: ``GC`` while a
        collection ran, else the innermost span's name."""
        inside, rest = cut(intervals, self.pauses)
        out: Dict[str, int] = defaultdict(int)
        for sid, ns in self.timeline.overlap(rest).items():
            out[self.name(sid)] += ns
        if inside:
            out[GC] += sum(e - s for s, e in inside)
        return out

    def most_open(self, a: int, b: int) -> str:
        """What the host did longest within [a, b]."""
        by = self.doing([(a, b)])
        return max(by, key=by.get) if by else OUTSIDE


def profiled(run) -> Optional[Profiled]:
    """The profiled request's ``Profiled``, where the traced run recorded the
    program's spans and its slice holds device operations."""
    recs = run.window.get("program_spans")
    sl = run.slice
    if not recs or sl is None or not sl.ops:
        return None
    rec = recs.get(run.window["profiled"])
    if rec is None or not rec.spans:
        return None
    return Profiled(rec, sl)


def idle_by_span(p: Profiled, top: int = 10) -> List[list]:
    """[[``GC`` or the innermost span's name, idle seconds]] of the slice,
    most first."""
    by = p.doing(p.idle)
    return [[n, ns / 1e9] for n, ns in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def device_by_span(p: Profiled, top: int = 10) -> List[list]:
    """[[launching span's name, device seconds, operations]] of the slice,
    most seconds first."""
    sec: Dict[str, float] = defaultdict(float)
    count: Dict[str, int] = defaultdict(int)
    for (_, s, e, _t), sid in zip(p.slice.ops, p.launched_in):
        sec[p.name(sid)] += (e - s) / 1e9
        count[p.name(sid)] += 1
    return [[n, sec[n], count[n]] for n in sorted(sec, key=lambda n: -sec[n])[:top]]
