"""Cells, configurations and metrics are found by name, from files of their
own; one added as files alone is picked up."""

import json
import os
import shutil

import pytest

from benchmark import cells

BENCH = cells.BENCH_DIR


def test_every_entry_of_benchmark_json_has_its_files():
    bench = cells.load_benchmark()
    for c in bench["configs"]:
        assert cells.load_config(c["name"])["name"] == c["name"]
        assert os.path.isfile(os.path.join(cells.ROOT, c["file"]))
    for w in bench["workloads"]:
        wl = cells.load_workload(w["name"])
        assert wl["config"] == w["config"] and wl["why"] == w["why"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(cells.metric_reader(m["name"]))


@pytest.mark.parametrize("trace,expected", [
    (False, {"video_request_s", "setup_s"}),
    (True, {"controller_ms.video", "denoise_ms.video", "vae_decode_ms.video", "mfu.video",
            "flash_fwd_roofline.video", "tattn_fwd_roofline.video", "device_idle.video",
            "unet_host_ms.video", "unet_kernels.video", "unet_launch_idle.video",
            "group_norm_roofline.video"}),
])
def test_metrics_for_follow_workloads_lists(trace, expected):
    names = {m["name"] for m in cells.metrics_for(cells.load_benchmark(),
                                                  "zeroscope_576w.video", trace)}
    assert names == expected


def test_unknown_names_raise():
    for load in (cells.load_workload, cells.load_config, cells.metric_reader):
        with pytest.raises(KeyError):
            load("no_such_name")


def test_a_cell_config_and_metric_added_as_files_alone(tmp_path):
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench_dir, ignore=shutil.ignore_patterns("__pycache__", "build_cache"))
    with open(bench_dir / "configs" / "sd15.json") as f:
        cfg = json.load(f)
    cfg["name"] = "sd15_copy"
    (bench_dir / "configs" / "sd15_copy.json").write_text(json.dumps(cfg))
    with open(bench_dir / "workloads" / "sd15.image.json") as f:
        wl = json.load(f)
    wl.update(name="sd15_copy.image_x3", config="sd15_copy", spans_per_answer=3)
    (bench_dir / "workloads" / "sd15_copy.image_x3.json").write_text(json.dumps(wl))
    (bench_dir / "metrics" / "spans_a_request.py").write_text(
        "def read(run):\n    return run.spans_per_request\n")
    bench = cells.load_benchmark()
    bench["per_layer"].append(dict(name="spans_a_request", unit="spans", better="higher",
                                   source="program_counter", layer="decoder controller",
                                   moves="image_request_s",
                                   workloads=["sd15_copy.image_x3"]))
    assert cells.load_config("sd15_copy", str(bench_dir))["name"] == "sd15_copy"
    assert cells.load_workload("sd15_copy.image_x3", str(bench_dir))["spans_per_answer"] == 3
    entries = cells.metrics_for(bench, "sd15_copy.image_x3", True)
    assert [m["name"] for m in entries] == ["spans_a_request"]

    class Run:
        spans_per_request = 3

    assert cells.read_metrics(entries, Run(), str(bench_dir)) == {
        "spans_a_request": {"value": 3, "unit": "spans"}}


def test_a_reader_that_finds_nothing_leaves_its_metric_out(tmp_path):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "silent.py").write_text("def read(run):\n    return None\n")
    entry = dict(name="silent", unit="%")
    assert cells.read_metrics([entry], object(), str(tmp_path)) == {}


def test_benchmark_json_has_the_required_shape():
    import re

    bench = cells.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
    line = lambda s: 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s
    assert 1 <= bench["run_seconds"] <= 51 and bench["paths"] == ["benchmark"]
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert name.match(c["name"]) and line(c["why"]) and line(c["source"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert name.match(w["name"]) and name.match(w["traffic"]) and line(w["why"])
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and line(m["layer"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert name.match(m["name"]) and unit.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in bench["workloads"]:       # every cell reports setup_s, one other, one per-layer
        assert len(cells.metrics_for(bench, w["name"], False)) >= 2
        assert cells.metrics_for(bench, w["name"], True)
