"""The readers of the program's spans (``program_spans.py``) on synthetic
spans and device timelines, and a tiny traced run on the CPU in which each
of the program's spans lies inside the benchmark's own span of the same
work."""

import json
import os
import types

import pytest
import torch

from benchmark import cells, program_spans as PS
from benchmark.loops import spider_decoder as D
from benchmark import roofline
from spider_tpu_torch.common.profiler import LaunchRecord, Recording, SpanRecord

DATA = os.path.join(os.path.dirname(__file__), "data")
MS = 1_000_000
ANCHOR = (5 * MS, 1_000_000 * MS)          # perf_counter_ns 5 ms is wall 1000 s


def _span(sid, name, parent, start_ms, end_ms, root=1):
    return SpanRecord(name, sid, parent, root, 7, {}, start_ms * MS + ANCHOR[0],
                      end_ms * MS + ANCHOR[0])


def _wall(ms):
    return ANCHOR[1] + int(ms * MS)


def _request(offset_ms=0.0):
    """request 0-100 ms: step 10-90 holding unet 20-80 holding unet.mid
    40-60; times shifted by `offset_ms`."""
    o = offset_ms
    return Recording([_span(1, "decoder.request", None, o + 0, o + 100),
                      _span(2, "pipeline.step", 1, o + 10, o + 90),
                      _span(3, "unet", 2, o + 20, o + 80),
                      _span(4, "unet.mid", 3, o + 40, o + 60)], [], ANCHOR)


def _slice(ops, t0_ms, t1_ms):
    """A SpanSlice's readings: ops [(name, start ms, end ms, launch ms)] on the
    wall clock, its ends on perf_counter_ns."""
    return types.SimpleNamespace(
        ops=[(n, _wall(s), _wall(e), None if t is None else _wall(t)) for n, s, e, t in ops],
        t0_ns=ANCHOR[0] + t0_ms * MS, t1_ns=ANCHOR[0] + t1_ms * MS,
        wall_s=(t1_ms - t0_ms) / 1e3)


# device ops of the profiled request (ms): launched in the step, in unet (x2),
# in unet.mid, in no span (before the request) and one without a launch
OPS = [("k_step", 12, 30, 11), ("k_unet_a", 30, 45, 21), ("k_mid", 50, 55, 41),
       ("k_unet_b", 70, 85, 61), ("k_before", 100, 104, -5), ("k_nolaunch", 104, 105, None)]


def _run():
    return types.SimpleNamespace(
        window=dict(profiled=1, program_spans={-1: _request(), 0: _request(), 1: _request()}),
        slice=_slice(OPS, -10, 110))


def test_innermost_segments_and_lookup():
    p = PS.Profiled(_request(), _slice(OPS, -10, 110))
    segs = [(s - ANCHOR[1], e - ANCHOR[1], p.name(sid)) for s, e, sid in p.timeline.segments]
    assert segs == [(0, 10 * MS, "decoder.request"), (10 * MS, 20 * MS, "pipeline.step"),
                    (20 * MS, 40 * MS, "unet"), (40 * MS, 60 * MS, "unet.mid"),
                    (60 * MS, 80 * MS, "unet"), (80 * MS, 90 * MS, "pipeline.step"),
                    (90 * MS, 100 * MS, "decoder.request")]
    assert [p.name(sid) for sid in p.launched_in] == [
        "pipeline.step", "unet", "unet.mid", "unet", PS.OUTSIDE, PS.OUTSIDE]


def test_unet_host_ms_leaves_out_the_warm_up_and_the_profiled_request():
    run = _run()
    recs = run.window["program_spans"]
    recs[0].spans[2].end_ns += 10 * MS                        # request 0's unet: 70 ms
    recs[-1].spans[2].end_ns += 500 * MS
    recs[1].spans[2].end_ns += 900 * MS
    assert PS.unet_host_ms(run) == pytest.approx(70.0)


def test_unet_kernels_counts_launches_inside_the_unet_subtree():
    assert PS.unet_kernels(_run()) == pytest.approx(3.0)       # k_unet_a, k_mid, k_unet_b


def test_idle_by_span_with_a_gap_outside_any_span():
    # slice -10..110 ms; busy 12-45, 50-55, 70-85, 100-105
    p = PS.Profiled(_request(), _slice(OPS, -10, 110))
    idle = dict((n, round(s * 1e3, 6)) for n, s in PS.idle_by_span(p))
    # idle: -10..12 (10 outside, 10 request, 2 step), 45..50 (unet.mid 40-60),
    # 55..70 (5 mid, 10 unet), 85..100 (5 step, 10 request), 105..110 (outside)
    assert idle == {PS.OUTSIDE: 15.0, "decoder.request": 20.0, "pipeline.step": 7.0,
                    "unet.mid": 10.0, "unet": 10.0}
    assert PS.unet_launch_idle(_run()) == pytest.approx(100 * 20e-3 / 0.12)
    cov = PS.coverage(p)
    assert cov["ops_in_spans"] == pytest.approx(4 / 6)
    assert cov["idle_in_spans"] == pytest.approx(1 - 15 / 62)


def test_device_by_span_by_launching_span():
    p = PS.Profiled(_request(), _slice(OPS, -10, 110))
    rows = {n: (round(s * 1e3, 6), c) for n, s, c in PS.device_by_span(p)}
    assert rows == {"pipeline.step": (18.0, 1), "unet": (30.0, 2), "unet.mid": (5.0, 1),
                    PS.OUTSIDE: (5.0, 2)}


def test_readers_find_nothing_without_the_program_spans():
    plain = types.SimpleNamespace(window=dict(profiled=1), slice=_slice(OPS, -10, 110))
    for read in (PS.unet_host_ms, PS.unet_kernels, PS.unet_launch_idle):
        assert read(plain) is None
    no_device = _run()
    no_device.slice = _slice([], -10, 110)
    assert PS.unet_kernels(no_device) is None and PS.unet_launch_idle(no_device) is None
    assert PS.unet_host_ms(no_device) is not None


FLASH = dict(B=2, T=4096, S=4096, Hq=8, Hkv=8, D=40, causal=False, elem_bytes=2)
TATTN = dict(B=2, F=24, P=2304, C=320, heads=8, elem_bytes=2)


def _launching(records, patched):
    """The profiled request with launch records [(kernel, span id, shape)],
    its slice with Slice's patched records and 2 ms of flash and 1 ms of
    tattn device time."""
    rec = _request()
    rec.launches = [LaunchRecord(k, "ampere", shape, sid, 0) for k, sid, shape in records]
    sl = _slice(OPS, -10, 110)
    sl.launches = patched
    sl.kernel_s = lambda sub: {"flash_fwd": 2e-3, "tattn": 1e-3}.get(sub, 0.0)
    return PS.Profiled(rec, sl)


def test_launch_rooflines_from_the_records_beside_the_slices():
    p = _launching([("flash_attention", 3, FLASH), ("flash_attention", 4, FLASH),
                    ("temporal_attention", 4, TATTN)],
                   {"flash_fwd": [FLASH, FLASH], "tattn_fwd": []})
    got = PS.launch_rooflines(p)
    flash = 100 * 2 * roofline.bound_s(*roofline.flash_fwd_cost(**FLASH)) / 2e-3
    tattn = 100 * roofline.bound_s(*roofline.tattn_fwd_cost(**TATTN)) / 1e-3
    assert got["flash_fwd_roofline"] == dict(records=pytest.approx(flash), slice=pytest.approx(flash),
                                             equal=True)
    assert got["tattn_fwd_roofline"] == dict(records=pytest.approx(tattn), slice=None, equal=False)
    assert PS.launches_by_span(p) == [["unet", "flash_attention", 1],
                                      ["unet.mid", "flash_attention", 1],
                                      ["unet.mid", "temporal_attention", 1]]


def test_launch_records_outside_any_span_and_none_at_all():
    p = _launching([("flash_attention", None, FLASH), ("flash_attention", None, FLASH),
                    ("flash_attention", 3, FLASH)], {"flash_fwd": [FLASH] * 3})
    assert PS.launches_by_span(p) == [[PS.OUTSIDE, "flash_attention", 2],
                                      ["unet", "flash_attention", 1]]
    assert set(PS.launch_rooflines(p)) == {"flash_fwd_roofline"}
    assert PS.launch_rooflines(_launching([], {"flash_fwd": [FLASH]})) == {}


def test_each_new_metric_has_its_reader_and_the_entries_fit_benchmark_json():
    bench = cells.load_benchmark()
    layers = {m["layer"] for m in bench["per_layer"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    cell_names = {w["name"] for w in bench["workloads"]}
    entries = (PS.unet_metrics("video", "zeroscope_576w.video")
               + PS.unet_metrics("image", "sd15.image"))
    assert len({m["name"] for m in entries}) == 6
    for m in entries:
        assert callable(cells.metric_reader(m["name"]))
        assert m["layer"] in layers and m["moves"] in e2e and set(m["workloads"]) <= cell_names
        assert m["moves"].split("_")[0] == m["name"].rsplit(".", 1)[1]


def _tiny(name):
    with open(os.path.join(DATA, name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("cell", ["tiny_sd.image", "tiny_vd.video"])
def test_a_tiny_traced_run_puts_each_program_span_inside_the_benchmarks(cell, capsys):
    from spider_tpu_torch.models.pipelines.sd import build_tiny_sd
    from spider_tpu_torch.models.pipelines.vd import build_tiny_vd

    wl = _tiny(cell)
    cfg = _tiny(wl["config"])
    video = wl["modality"] == "VIDEO"
    tiny = build_tiny_vd if video else build_tiny_sd
    build = lambda c, d: tiny(device=d)  # noqa: E731
    kw = dict(num_inference_steps=3, **(dict(height=32, width=32, num_frames=4) if video else {}))
    args = types.SimpleNamespace(workload=wl["name"], seed=2 ** 33 + 29, seconds=0.5, trace=0,
                                 cell_kwargs=dict(build=build, call_kwargs=kw))
    rc, run = PS.execute(args, cells.load_benchmark(), wl, cfg, D, torch.device("cpu"))
    assert rc == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(result)[-1] == "checks" and result["failed"] == 0
    kind = "video" if video else "image"
    assert f"unet_host_ms.{kind}" in result["metrics"]
    recs = PS.program_spans_of(run)
    assert run.spans.keys() <= recs.keys()
    twins = {"request": "decoder.request", "denoise": "pipeline.denoise",
             "vae_decode": "pipeline.vae_decode"}
    slack = 1_000                                   # ns: perf_counter's float against _ns
    for i, bench_spans in run.spans.items():
        prog = recs[i].spans
        for kind_, name in twins.items():
            mine = [s for s in prog if s.name == name]
            assert len(mine) == len(bench_spans[kind_]) >= 1
            for s, (b0, b1) in zip(sorted(mine, key=lambda s: s.start_ns), bench_spans[kind_]):
                assert b0 * 1e9 - slack <= s.start_ns <= s.end_ns <= b1 * 1e9 + slack
        assert sum(s.name == "unet" for s in prog) == 3
    gaps = PS.twin_gaps_ms(run)
    assert set(gaps) <= {"request", "denoise", "vae_decode"}
    assert all(g >= -1e-3 for g in gaps.values())
