"""A traced run with the program's own spans and launch records
(``spider_tpu_torch/common/profiler.py``), and what is read from them.

    python3 benchmark/program_spans.py --workload <cell> --seed <n> --seconds <s>

from the root of a checkout runs the cell as ``run.py --trace 1`` does, with
three things more:

  - set-up and the window run under the program's ``profiler.recording()``,
    and the spans and launches of each request are drained after it (the
    window's ``program_spans``, by request index; the warm-up is -1);
  - the profiled slice is a ``SpanSlice``: it also keeps each device
    operation on the profiler's clock (nanoseconds since the epoch, the
    clock of ``time.time_ns``) with the host time of the CUDA call that
    launched it (the runtime event of the same correlation id), so that each
    operation is put down to the innermost program span open on the host
    when it was launched;
  - the result line also holds the cell's ``unet_metrics``, and standard
    error two tables: ``idle by span``, the slice's device-idle seconds by the
    innermost program span open on the host meanwhile ("outside any span"
    where none was), and ``device by span``, device seconds and operations
    by launching span; and the flash and temporal-attention rooflines worked
    out from the program's launch records (``launch_rooflines``) beside the
    same shares from ``Slice``'s patched records, with the launch records by
    span.

The loop's own ``run_window`` runs with ``SpanSlice`` in place of
``profiling.Slice`` in a copy of its globals (``with_globals``), and its
``Cell`` is subclassed: no module of the benchmark is changed.

The readers of ``metrics/unet_*.py`` are here; they find nothing in a run
made by ``run.py`` as it stands, which does not record the program's spans.
Times are nanoseconds: a span's ``perf_counter_ns`` readings go to the
profiler's clock through the recording's anchor (``Recording.wall_ns``).
"""

from __future__ import annotations

import bisect
import os
import sys
import time
import types
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import profiling, roofline, run  # noqa: E402

OUTSIDE = "outside any span"
UNET = "unet"

UNET_READS = (("unet_host_ms", "ms", "program_span"), ("unet_kernels", "ops", "device_trace"),
              ("unet_launch_idle", "%", "program_span"))


def unet_metrics(kind: str, cell: str) -> List[dict]:
    """The per-layer entries these readers serve in `cell` ("video" or
    "image" in the name), as BENCHMARK.json would list them."""
    return [dict(name=f"{metric}.{kind}", unit=unit, better="lower", source=source,
                 layer="model step", moves=f"{kind}_request_s", workloads=[cell])
            for metric, unit, source in UNET_READS]


class SpanSlice(profiling.Slice):
    """``profiling.Slice``, keeping besides ``ops`` [(name, start_ns,
    end_ns, launch_ns or None)]: each device operation, and the host time
    of its launch, on the profiler's clock; and ``t0_ns``, ``t1_ns``, the
    slice's ends on ``perf_counter_ns``."""

    def __exit__(self, *exc):
        import torch

        prof = self._prof
        out = super().__exit__(*exc)
        self.t0_ns = round(self._t0 * 1e9)
        self.t1_ns = self.t0_ns + round(self.wall_s * 1e9)
        results = prof.profiler.kineto_results
        device = torch.autograd.DeviceType.CUDA if self.device.type == "cuda" else None
        launch: Dict[int, int] = {}
        ops = []
        for e in results.events():
            if e.is_user_annotation():
                continue
            if e.device_type() == device:
                ops.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                            e.correlation_id()))
            elif e.correlation_id():
                c = e.correlation_id()
                launch[c] = min(launch.get(c, e.start_ns()), e.start_ns())
        self.ops = [(name, s, e, launch.get(c)) for name, s, e, c in ops]
        return out


# ---------------------------------------------------------------- arithmetic
Segment = Tuple[int, int, Optional[object]]


def on_clock(rec) -> Dict[int, tuple]:
    """{id: (name, parent, start_ns, end_ns)} of a recording's spans on the
    profiler's clock."""
    return {s.id: (s.name, s.parent, rec.wall_ns(s.start_ns), rec.wall_ns(s.end_ns))
            for s in rec.spans}


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


def idle_intervals(ops, t0: int, t1: int) -> List[Tuple[int, int]]:
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


# ------------------------------------------------------------------ readers
def program_spans_of(run_) -> Optional[dict]:
    """{request index: ``Recording``} of a run made here; None for a run
    that did not record the program's spans."""
    return (getattr(run_, "window", None) or {}).get("program_spans")


class Profiled:
    """The profiled request's spans beside its slice: ``spans`` on the
    profiler's clock, their ``timeline``, each device operation's launching
    span (``launched_in``) and the slice's ``idle`` stretches."""

    def __init__(self, rec, sl):
        self.rec, self.slice = rec, sl
        self.spans = on_clock(rec)
        self.timeline = Timeline(self.spans)
        self.launched_in = [self.timeline.at(t) for *_x, t in sl.ops]
        self.idle = idle_intervals(sl.ops, rec.wall_ns(sl.t0_ns), rec.wall_ns(sl.t1_ns))

    def name(self, sid: Optional[int]) -> str:
        return OUTSIDE if sid is None else self.spans[sid][0]

    def idle_by(self) -> Dict[Optional[int], int]:
        return self.timeline.overlap(self.idle)


def profiled(run_) -> Optional[Profiled]:
    """The profiled request's ``Profiled``, where the run recorded the
    program's spans and a ``SpanSlice`` holding device operations."""
    recs = program_spans_of(run_)
    sl = run_.slice
    if not recs or not getattr(sl, "ops", None):      # no device operation traced
        return None
    rec = recs.get(run_.window["profiled"])
    if rec is None or not rec.spans:
        return None
    return Profiled(rec, sl)


def unet_host_ms(run_) -> Optional[float]:
    """Mean host length of the program's ``unet`` spans over the traced
    requests outside the profiled slice (the warm-up left out)."""
    recs = program_spans_of(run_)
    if not recs:
        return None
    lengths = [s.end_ns - s.start_ns for i, rec in recs.items()
               if i >= 0 and i != run_.window["profiled"]
               for s in rec.spans if s.name == UNET]
    return sum(lengths) / len(lengths) / 1e6 if lengths else None


def unet_kernels(run_) -> Optional[float]:
    """Device operations launched inside one ``unet`` span, mean over the
    profiled slice's UNet calls."""
    p = profiled(run_)
    calls = sum(v[0] == UNET for v in p.spans.values()) if p else 0
    if not calls:
        return None
    in_unet = under(p.spans, UNET)
    return sum(in_unet.get(sid) is not None for sid in p.launched_in) / calls


def unet_launch_idle(run_) -> Optional[float]:
    """100 x the profiled slice's device-idle seconds during which the host
    was inside a ``unet`` span, over the slice's wall seconds."""
    p = profiled(run_)
    if p is None or p.slice.wall_s <= 0:
        return None
    in_unet = under(p.spans, UNET)
    ns = sum(v for sid, v in p.idle_by().items() if in_unet.get(sid) is not None)
    return 100.0 * ns / 1e9 / p.slice.wall_s


def idle_by_span(p: Profiled, top: int = 10) -> List[list]:
    """[[innermost span's name, idle seconds]] of the slice, most first."""
    by: Dict[str, float] = defaultdict(float)
    for sid, ns in p.idle_by().items():
        by[p.name(sid)] += ns / 1e9
    return [[n, sec] for n, sec in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def device_by_span(p: Profiled, top: int = 10) -> List[list]:
    """[[launching span's name, device seconds, operations]] of the slice,
    most seconds first."""
    sec: Dict[str, float] = defaultdict(float)
    count: Dict[str, int] = defaultdict(int)
    for (_, s, e, _t), sid in zip(p.slice.ops, p.launched_in):
        sec[p.name(sid)] += (e - s) / 1e9
        count[p.name(sid)] += 1
    return [[n, sec[n], count[n]] for n in sorted(sec, key=lambda n: -sec[n])[:top]]


def twin_gaps_ms(run_) -> Dict[str, float]:
    """Mean of (the benchmark's span less the program's twin of it), in ms,
    over the traced requests outside the profiled slice: what the
    benchmark's own span holds besides the program's (its synchronise after
    the denoise loop, its own calls around a request)."""
    twins = dict(request="decoder.request", denoise="pipeline.denoise",
                 vae_decode="pipeline.vae_decode")
    gaps: Dict[str, List[float]] = defaultdict(list)
    recs = program_spans_of(run_) or {}
    for i, bench in run_.spans.items():
        if i < 0 or i == run_.window["profiled"] or i not in recs:
            continue
        prog = recs[i].spans
        for kind, name in twins.items():
            mine = sorted((s for s in prog if s.name == name), key=lambda s: s.start_ns)
            for s, (b0, b1) in zip(mine, bench.get(kind, [])):
                gaps[kind].append((b1 - b0) * 1e3 - (s.end_ns - s.start_ns) / 1e6)
    return {k: sum(v) / len(v) for k, v in gaps.items() if v}


# the program's launch records by kernel wrapper: Slice's name for the same
# launches, the cost of one launch (roofline.py), and the substring of its
# device operations' names
LAUNCHED = dict(flash_attention=("flash_fwd", roofline.flash_fwd_cost, "flash_fwd"),
                temporal_attention=("tattn_fwd", roofline.tattn_fwd_cost, "tattn"))


def launch_rooflines(p: Profiled) -> Dict[str, dict]:
    """Each kernel's share of its roofline in the profiled slice, worked out
    from the program's launch records, beside the same share from
    ``Slice``'s patched records: {"flash_fwd_roofline": dict(records=%,
    slice=% or None, equal=whether the two lists of shapes are equal)}."""
    out = {}
    for kernel, (name, cost, substring) in LAUNCHED.items():
        shapes = [r.shape for r in p.rec.launches if r.kernel == kernel]
        if not shapes:
            continue
        patched = getattr(p.slice, "launches", {}).get(name)
        device_s = p.slice.kernel_s(substring)
        out[f"{name}_roofline"] = dict(
            records=roofline.share_percent(shapes, cost, device_s),
            slice=roofline.share_percent(patched, cost, device_s) if patched else None,
            equal=patched == shapes)
    return out


def launches_by_span(p: Profiled, top: int = 10) -> List[list]:
    """[[innermost span's name, kernel wrapper, launches]] of the profiled
    request's launch records, most first."""
    count: Dict[Tuple[str, str], int] = defaultdict(int)
    for r in p.rec.launches:
        count[p.name(r.span if r.span in p.spans else None), r.kernel] += 1
    return [[n, k, c] for (n, k), c in sorted(count.items(), key=lambda kv: -kv[1])[:top]]


def coverage(p: Profiled) -> dict:
    """Shares of the slice's device operations launched inside some span,
    and of its idle time during which some span was open."""
    idle = p.idle_by()
    total = sum(idle.values())
    ops = p.launched_in
    return dict(ops_in_spans=sum(sid is not None for sid in ops) / len(ops) if ops else None,
                idle_in_spans=1 - idle.get(None, 0) / total if total else None)


# ----------------------------------------------------------------- the run
def with_globals(fn, **names):
    """A copy of function `fn` that sees `names` in place of its module's
    globals of those names; the module itself is left as it is."""
    return types.FunctionType(fn.__code__, {**fn.__globals__, **names}, fn.__name__,
                              fn.__defaults__, fn.__closure__)


def traced(loop):
    """`loop` with its ``Cell`` recording the program's spans, drained
    after each request into the window's ``program_spans``, and its profiled
    slice a ``SpanSlice``."""
    from spider_tpu_torch.common import profiler

    class Cell(loop.Cell):
        def __init__(self, *a, **kw):
            self.program_spans = {}
            super().__init__(*a, **kw)

        def serve(self, index):
            try:
                return super().serve(index)
            finally:
                self.program_spans[index] = profiler.drain()

    window_of = with_globals(loop.run_window,
                             profiling=types.SimpleNamespace(Slice=SpanSlice))

    def run_window(cell, seconds, trace):
        return dict(window_of(cell, seconds, trace), program_spans=cell.program_spans)

    return types.SimpleNamespace(Cell=Cell, run_window=run_window, warm_up=loop.warm_up,
                                 check_sample=loop.check_sample, records_of=loop.records_of,
                                 reference_for=loop.reference_for)


def execute(args, bench, workload, config, loop, device):
    """``run.execute`` with the program's spans recorded, then the tables;
    -> (its exit code, the ``run.Run`` its metrics were read from)."""
    from spider_tpu_torch.common import profiler

    args.trace = 1
    kind = "video" if workload["modality"] == "VIDEO" else "image"
    listed = {e["name"] for e in bench["per_layer"]}
    bench = dict(bench, per_layer=bench["per_layer"] + [
        m for m in unet_metrics(kind, workload["name"]) if m["name"] not in listed])
    kept = {}

    def keep_run(**kw):
        kept["run"] = run.Run(**kw)
        return kept["run"]

    profiler.drain()
    with profiler.recording():
        rc = with_globals(run.execute, Run=keep_run)(args, bench, workload, config,
                                                     traced(loop), device)
    r = kept.get("run")
    p = profiled(r) if r is not None else None
    if r is not None:
        print(f"benchmark span less the program's twin (ms): {twin_gaps_ms(r)}",
              file=sys.stderr)
    if p is not None:
        print(f"coverage: {coverage(p)}", file=sys.stderr)
        print("idle by span (s): " + "; ".join(f"{n} {sec:.6f}" for n, sec in idle_by_span(p)),
              file=sys.stderr)
        print("device by span (s, ops): " + "; ".join(
            f"{n} {sec:.6f} {c}" for n, sec, c in device_by_span(p)), file=sys.stderr)
        print(f"rooflines from the launch records (%), beside Slice's: {launch_rooflines(p)}",
              file=sys.stderr)
        print("launch records by span: " + "; ".join(
            f"{n} {k} {c}" for n, k, c in launches_by_span(p)), file=sys.stderr)
    return rc, r


def main(argv=None) -> int:
    import importlib

    import torch

    from benchmark import cells

    args = run.parse(argv)
    bench = cells.load_benchmark()
    workload = cells.load_workload(args.workload)
    config = cells.load_config(workload["config"])
    if not torch.cuda.is_available():
        print("a traced run of the program's spans needs a CUDA device", file=sys.stderr)
        return 2
    loop = importlib.import_module(f"benchmark.loops.{workload['loop']}")
    t0 = time.perf_counter()
    rc = execute(args, bench, workload, config, loop, torch.device("cuda", 0))[0]
    print(f"program_spans run: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
