"""The readers of the program's spans and launch records (``profiling.py``,
``readers.py``) on synthetic spans and device timelines, and tiny runs on
the CPU through ``run.execute``: traced, each of the program's spans lies
inside the benchmark's own span of the same work; untraced, nothing is
recorded."""

import json
import os
import types

import pytest
import torch

from benchmark import cells, check, profiling as P, readers, roofline, run
from benchmark.loops import spider_decoder as D
from spider_tpu_torch.common.profiler import LaunchRecord, Recording, SpanRecord

DATA = os.path.join(os.path.dirname(__file__), "data")
MS = 1_000_000
ANCHOR = (5 * MS, 1_000_000 * MS)          # perf_counter_ns 5 ms is wall 1000 s


def _span(sid, name, parent, start_ms, end_ms, root=1):
    return SpanRecord(name, sid, parent, root, 7, {}, start_ms * MS + ANCHOR[0],
                      end_ms * MS + ANCHOR[0])


def _wall(ms):
    return ANCHOR[1] + int(ms * MS)


def _request(unet_end_ms=80, launches=()):
    """request 0-100 ms: step 10-90 holding unet 20-80 (or to `unet_end_ms`)
    holding unet.mid 40-60, as the loop keeps it."""
    return P.compact(Recording([_span(1, "decoder.request", None, 0, 100),
                                _span(2, "pipeline.step", 1, 10, 90),
                                _span(3, "unet", 2, 20, unet_end_ms),
                                _span(4, "unet.mid", 3, 40, 60)], list(launches), ANCHOR))


def _slice(ops, t0_ms, t1_ms):
    """A Slice holding ops [(name, start ms, end ms, launch ms)] on the wall
    clock, its ends on perf_counter_ns."""
    sl = P.Slice("cpu")
    sl.ops = [(n, _wall(s), _wall(e), None if t is None else _wall(t)) for n, s, e, t in ops]
    sl.t0_ns, sl.t1_ns = ANCHOR[0] + t0_ms * MS, ANCHOR[0] + t1_ms * MS
    sl.wall_s = (t1_ms - t0_ms) / 1e3
    return sl


# device ops of the profiled request (ms): launched in the step, in unet (x2),
# in unet.mid, in no span (before the request) and one without a launch
OPS = [("k_step", 12, 30, 11), ("k_unet_a", 30, 45, 21), ("k_mid", 50, 55, 41),
       ("k_unet_b", 70, 85, 61), ("k_before", 100, 104, -5), ("k_nolaunch", 104, 105, None)]


def _run():
    return types.SimpleNamespace(
        window=dict(profiled=1, program_spans={-1: _request(), 0: _request(), 1: _request()}),
        slice=_slice(OPS, -10, 110))


def test_innermost_segments_and_lookup():
    p = P.Profiled(_request(), _slice(OPS, -10, 110))
    segs = [(s - ANCHOR[1], e - ANCHOR[1], p.name(sid)) for s, e, sid in p.timeline.segments]
    assert segs == [(0, 10 * MS, "decoder.request"), (10 * MS, 20 * MS, "pipeline.step"),
                    (20 * MS, 40 * MS, "unet"), (40 * MS, 60 * MS, "unet.mid"),
                    (60 * MS, 80 * MS, "unet"), (80 * MS, 90 * MS, "pipeline.step"),
                    (90 * MS, 100 * MS, "decoder.request")]
    assert [p.name(sid) for sid in p.launched_in] == [
        "pipeline.step", "unet", "unet.mid", "unet", P.OUTSIDE, P.OUTSIDE]


def test_unet_host_ms_leaves_out_the_warm_up_and_the_profiled_request():
    run_ = _run()
    run_.window["program_spans"] = {-1: _request(580), 0: _request(90), 1: _request(980)}
    assert readers.unet_host_ms(run_) == pytest.approx(70.0)   # request 0's unet


def test_compact_records_leave_the_collectors_tracking():
    import gc

    rec = P.compact(Recording([_span(1, "unet", None, 0, 1)],
                              [LaunchRecord("group_norm", "split", dict(NORM), 1, 0)], ANCHOR))
    gc.collect()
    assert not any(gc.is_tracked(x) for x in rec.spans + rec.launches["group_norm"])
    assert rec.spans == [("unet", 1, None, ANCHOR[0], ANCHOR[0] + MS)]
    assert rec.launches == {"group_norm": [NORM]} and rec.wall_ns(ANCHOR[0]) == ANCHOR[1]


def test_unet_kernels_counts_launches_inside_the_unet_subtree():
    assert readers.unet_kernels(_run()) == pytest.approx(3.0)  # k_unet_a, k_mid, k_unet_b


def test_idle_by_span_with_a_gap_outside_any_span():
    # slice -10..110 ms; busy 12-45, 50-55, 70-85, 100-105
    p = P.Profiled(_request(), _slice(OPS, -10, 110))
    idle = dict((n, round(s * 1e3, 6)) for n, s in P.idle_by_span(p))
    # idle: -10..12 (10 outside, 10 request, 2 step), 45..50 (unet.mid 40-60),
    # 55..70 (5 mid, 10 unet), 85..100 (5 step, 10 request), 105..110 (outside)
    assert idle == {P.OUTSIDE: 15.0, "decoder.request": 20.0, "pipeline.step": 7.0,
                    "unet.mid": 10.0, "unet": 10.0}
    assert readers.unet_launch_idle(_run()) == pytest.approx(100 * 20e-3 / 0.12)


def test_idle_gaps_are_named_by_the_span_open_most_of_them():
    p = P.Profiled(_request(), _slice(OPS, -10, 110))
    # gaps between operations: 45-50 in unet.mid, 55-70 (unet.mid 5, unet 10),
    # 85-100 (step 5, request 10)
    assert p.slice.idle_gaps(p) == [
        ["unet: before k_unet_b", pytest.approx(15e-3)],
        ["decoder.request: before k_before", pytest.approx(15e-3)],
        ["unet.mid: before k_mid", pytest.approx(5e-3)]]
    assert [g[0] for g in p.slice.idle_gaps()] == [
        f"{P.OUTSIDE}: before k_unet_b", f"{P.OUTSIDE}: before k_before",
        f"{P.OUTSIDE}: before k_mid"]


def test_idle_in_a_collection_goes_to_gc_and_device_idle_keeps_it():
    sl = _slice(OPS, -10, 110)
    sl.collections = [(ANCHOR[0] + 56 * MS, ANCHOR[0] + 66 * MS)]
    p = P.Profiled(_request(), sl)
    idle = dict((n, round(s * 1e3, 6)) for n, s in P.idle_by_span(p))
    # the gap 55..70 ms: unet.mid 55-56, the collection 56-66, unet 66-70
    assert idle == {P.OUTSIDE: 15.0, "decoder.request": 20.0, "pipeline.step": 7.0,
                    P.GC: 10.0, "unet.mid": 6.0, "unet": 4.0}
    assert p.slice.idle_gaps(p)[0] == ["gc: before k_unet_b", pytest.approx(15e-3)]
    run_ = _run()
    run_.slice = sl
    assert readers.unet_launch_idle(run_) == pytest.approx(100 * 20e-3 / 0.12)
    assert readers.device_idle(run_) == pytest.approx(100 * (1 - 58 / 120))


def test_device_by_span_by_launching_span():
    p = P.Profiled(_request(), _slice(OPS, -10, 110))
    rows = {n: (round(s * 1e3, 6), c) for n, s, c in P.device_by_span(p)}
    assert rows == {"pipeline.step": (18.0, 1), "unet": (30.0, 2), "unet.mid": (5.0, 1),
                    P.OUTSIDE: (5.0, 2)}


def test_readers_find_nothing_without_the_program_spans():
    plain = types.SimpleNamespace(window=dict(profiled=1), slice=_slice(OPS, -10, 110))
    for read in (readers.unet_host_ms, readers.unet_kernels, readers.unet_launch_idle,
                 readers.flash_fwd_roofline, readers.group_norm_roofline):
        assert read(plain) is None
    no_device = _run()
    no_device.slice = _slice([], -10, 110)
    assert readers.unet_kernels(no_device) is None
    assert readers.unet_launch_idle(no_device) is None
    assert readers.unet_host_ms(no_device) is not None


FLASH = dict(B=2, T=4096, S=4096, Hq=8, Hkv=8, D=40, causal=False, elem_bytes=2)
TATTN = dict(B=2, F=24, P=2304, C=320, heads=8, elem_bytes=2)
NORM = dict(N=2, C=320, L=16 * 2880, G=32, silu=True, elem_bytes=2)
# device time (s) of the operations each roofline reads
DEVICE = {"flash_fwd_wgmma_kernel": 2e-3, "tattn_ring_kernel": 1e-3,
          "void (anonymous namespace)::stats_cl<__nv_bfloat16>": 0.1e-3,
          "void (anonymous namespace)::apply_cl<true, __nv_bfloat16>": 0.1e-3,
          "void (anonymous namespace)::stats_contig<__nv_bfloat16>": 0.05e-3,
          "void (anonymous namespace)::apply_contig<false, __nv_bfloat16>": 0.05e-3,
          "at::native::RowwiseMomentsCUDAKernel": 9.0}


def _launching(records):
    """A run whose profiled request has launch records [(kernel, span id,
    shape)] and whose slice holds DEVICE's operations end to end."""
    rec = _request(launches=[LaunchRecord(k, "route", shape, sid, 0) for k, sid, shape in records])
    ops, t = [], 0.0
    for name, sec in DEVICE.items():
        ops.append((name, t, t + sec * 1e3, None))
        t += sec * 1e3
    return types.SimpleNamespace(window=dict(profiled=0, program_spans={0: rec}),
                                 slice=_slice(ops, 0, t))


def test_rooflines_read_the_launch_records():
    got = _launching([("flash_attention", 3, FLASH), ("flash_attention", 4, FLASH),
                      ("temporal_attention", 4, TATTN), ("group_norm", 3, NORM),
                      ("group_norm", 4, NORM)])
    flash = 100 * 2 * roofline.bound_s(*roofline.flash_fwd_cost(**FLASH)) / 2e-3
    tattn = 100 * roofline.bound_s(*roofline.tattn_fwd_cost(**TATTN)) / 1e-3
    norm = 100 * 2 * roofline.bound_s(*roofline.group_norm_cost(**NORM)) / 0.3e-3
    assert readers.flash_fwd_roofline(got) == pytest.approx(flash)
    assert readers.tattn_fwd_roofline(got) == pytest.approx(tattn)
    assert readers.group_norm_roofline(got) == pytest.approx(norm)     # ATen's left out


def test_launch_records_outside_any_span_and_none_at_all():
    outside = _launching([("flash_attention", None, FLASH), ("flash_attention", None, FLASH),
                          ("flash_attention", 3, FLASH)])
    flash = 100 * 3 * roofline.bound_s(*roofline.flash_fwd_cost(**FLASH)) / 2e-3
    assert readers.flash_fwd_roofline(outside) == pytest.approx(flash)
    assert readers.tattn_fwd_roofline(outside) is None
    none = _launching([])
    for read in (readers.flash_fwd_roofline, readers.tattn_fwd_roofline,
                 readers.group_norm_roofline):
        assert read(none) is None


def test_each_new_metric_has_its_reader_and_the_entries_fit_benchmark_json():
    bench = cells.load_benchmark()
    cell_names = {w["name"] for w in bench["workloads"]}
    entries = [m for m in bench["per_layer"]
               if m["name"].split(".")[0] in ("unet_host_ms", "unet_kernels", "unet_launch_idle",
                                              "group_norm_roofline")]
    assert len(entries) == 8
    for m in entries:
        assert callable(cells.metric_reader(m["name"]))
        assert set(m["workloads"]) <= cell_names
        assert m["moves"].split("_")[0] == m["name"].rsplit(".", 1)[1]
    layers = {m["name"]: m["layer"] for m in entries}
    assert layers["group_norm_roofline.video"] == "kernels"
    assert layers["unet_kernels.image"] == "model step"


def _tiny(name):
    with open(os.path.join(DATA, name + ".json")) as f:
        return json.load(f)


def _execute(wl, trace, monkeypatch, bench=None, wrap_unet=None, seed=2 ** 33 + 29):
    """run.execute on a tiny cell on the CPU; -> (its exit code, the Run its
    metrics were read from)."""
    from spider_tpu_torch.models.pipelines.sd import build_tiny_sd
    from spider_tpu_torch.models.pipelines.vd import build_tiny_vd

    cfg = _tiny(wl["config"])
    video = wl["modality"] == "VIDEO"

    def build(c, d):
        pipe = build_tiny_vd(device=d) if video else build_tiny_sd(device=d)
        if wrap_unet is not None:
            pipe.unet = wrap_unet(pipe.unet)
        return pipe

    kw = dict(num_inference_steps=3, **(dict(height=32, width=32, num_frames=4) if video else {}))
    args = types.SimpleNamespace(workload=wl["name"], seed=seed, seconds=0.5, trace=trace,
                                 cell_kwargs=dict(build=build, call_kwargs=kw))
    kept = []

    class Kept(run.Run):
        def __init__(self, **k):
            super().__init__(**k)
            kept.append(self)

    monkeypatch.setattr(run, "Run", Kept)
    rc = run.execute(args, bench or cells.load_benchmark(), wl, cfg, D, torch.device("cpu"))
    return rc, kept[-1] if kept else None


def _with_tiny_entries(cell, names):
    """BENCHMARK.json with `cell` added to the workloads of `names`."""
    bench = cells.load_benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in names:
            m["workloads"] = m.get("workloads", []) + [cell]
    return bench


@pytest.mark.parametrize("cell", ["tiny_sd.image", "tiny_vd.video"])
def test_a_tiny_traced_run_puts_each_program_span_inside_the_benchmarks(
        cell, capsys, monkeypatch):
    wl = _tiny(cell)
    kind = "video" if wl["modality"] == "VIDEO" else "image"
    bench = _with_tiny_entries(cell, {f"unet_host_ms.{kind}"})
    rc, r = _execute(wl, 1, monkeypatch, bench)
    assert rc == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(result)[-1] == "checks" and result["failed"] == 0
    assert f"unet_host_ms.{kind}" in result["metrics"]
    recs = r.window["program_spans"]
    assert r.spans.keys() <= recs.keys() and -1 not in recs
    twins = {"request": "decoder.request", "denoise": "pipeline.denoise",
             "vae_decode": "pipeline.vae_decode"}
    slack = 1_000                                   # ns: perf_counter's float against _ns
    for i, bench_spans in r.spans.items():
        prog = recs[i].spans
        for kind_, name in twins.items():
            mine = sorted((s, e) for n, _i, _p, s, e in prog if n == name)
            assert len(mine) == len(bench_spans[kind_]) >= 1
            for (s, e), (b0, b1) in zip(mine, bench_spans[kind_]):
                assert b0 * 1e9 - slack <= s <= e <= b1 * 1e9 + slack
        assert sum(n == "unet" for n, *_x in prog) == 3


def test_nothing_is_recorded_under_trace_0(capsys, monkeypatch):
    from spider_tpu_torch.common import profiler

    seen = {0: [], 1: []}
    trace = {"now": 0}

    def wrap(unet):
        class Noting:
            def __getattr__(self, name):
                return getattr(unet, name)

            def __call__(self, *a, **kw):
                seen[trace["now"]].append(profiler.recording_on())
                return unet(*a, **kw)

        return Noting()

    for t in (0, 1):
        trace["now"] = t
        rc, r = _execute(_tiny("tiny_sd.image"), t, monkeypatch, wrap_unet=wrap)
        assert rc == 0
        assert (r.window["program_spans"] is None) is (t == 0)
    capsys.readouterr()
    assert seen[0] and not any(seen[0])
    assert seen[1] and all(seen[1])
    assert not profiler.recording_on()


def test_a_tiny_image_x3_run_serves_three_spans_a_request_and_counts_them_all(
        capsys, monkeypatch):
    wl = dict(_tiny("tiny_sd.image"), name="tiny_sd.image_x3", spans_per_answer=3)
    bench = _with_tiny_entries(wl["name"], {"mfu.image", "image_request_s"})
    rc, r = _execute(wl, 1, monkeypatch, bench, seed=2 ** 33 + 31)
    assert rc == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["failed"] == 0 and list(result["checks"]) == list(check.NAMES)
    traced = readers._traced(r)
    assert traced and all(len(s["decoder"]) == 3 and len(s["denoise"]) == 3 for s in traced)
    for i, rec in r.window["program_spans"].items():
        assert sum(n == "decoder.dispatch" for n, *_x in rec.spans) == 3, i
    ops = sum(3 * r.flops["total"] for _ in traced)
    sec = sum(e - b for s in traced for b, e in s["request"])
    assert result["metrics"]["mfu.image"]["value"] == pytest.approx(
        100 * ops / sec / roofline.BF16_FLOP_PER_S)
