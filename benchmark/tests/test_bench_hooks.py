"""A configuration brings its own models: a loop module registered only in
this test, with its own ``request_flops``, reference, ``program_numbers``
and ``CHECK_NAMES``, runs through ``run.execute`` on the CPU, traced and
untraced, with no file of the benchmark added; and a workload whose limits
name other numbers than its loop compares is refused before set-up."""

import contextlib
import importlib
import json
import sys
import time
import types

import pytest
import torch

from benchmark import cells, profiling, run

NAME = "benchmark.loops.squares_only_in_this_test"
WIDTH = 16


class Cell:
    """A "model" y = tanh(x @ W) in fp32 from the seed; each request two
    spans of a few rows."""

    def __init__(self, workload, config, seed, device, trace=False, broken=False):
        self.workload, self.config, self.seed, self.device = workload, config, seed, device
        g = torch.Generator().manual_seed(seed)
        self.w = torch.randn(WIDTH, WIDTH, generator=g)
        self.broken = broken
        self.records = {}
        self.spans = types.SimpleNamespace(by_request={})
        self.trace = trace

    def serve(self, index):
        t0 = time.perf_counter()
        outs = []
        for span in range(2):
            x = torch.randn(4, WIDTH, generator=torch.Generator().manual_seed(
                self.seed + 7 * index + span))
            b0 = time.perf_counter()
            y = torch.tanh(x @ self.w)
            if self.broken:
                y = y.clone()
                y[0] = 0.0
            outs.append((x, y))
            self.spans.by_request.setdefault(index, {}).setdefault("decoder", []).append(
                (b0, time.perf_counter()))
        self.records[index] = outs
        self.spans.by_request[index].setdefault("request", []).append((t0, time.perf_counter()))

    def free_program(self):
        self.w = None


def warm_up(cell):
    t0 = time.perf_counter()
    cell.serve(-1)
    cell.spans.by_request.pop(-1)
    return time.perf_counter() - t0


def run_window(cell, seconds):
    lat, t0, index, profiled, sl = [], time.perf_counter(), 0, None, None
    while time.perf_counter() - t0 < seconds or index < 3:
        with contextlib.ExitStack() as stack:
            if cell.trace and index == 2:
                sl, profiled = stack.enter_context(profiling.Slice(cell.device)), index
            s = time.perf_counter()
            cell.serve(index)
            lat.append(time.perf_counter() - s)
        index += 1
    return dict(window_s=time.perf_counter() - t0, latencies=lat, attempted=len(lat), failed=0,
                failed_requests=[], profiled=profiled, slice=sl, program_spans=None)


def check_sample(workload, seed, completed):
    return completed[: workload["check"]["requests"]]


def records_of(cell, indices):
    return [pair for i in indices for pair in cell.records[i]]


def reference_for(cell):
    """The same model in fp64, its weights drawn again from the seed."""
    g = torch.Generator().manual_seed(cell.seed)
    return torch.randn(WIDTH, WIDTH, generator=g).double()


def request_flops(config, point):
    return dict(total=2 * 2 * 4 * WIDTH * WIDTH)


CHECK_NAMES = ("max_abs",)


def program_numbers(ref, records):
    return dict(max_abs=max(float((y.double() - torch.tanh(x.double() @ ref)).abs().max())
                            for x, y in records))


@pytest.fixture
def loop(monkeypatch):
    module = types.ModuleType(NAME)
    for name in ("Cell", "warm_up", "run_window", "check_sample", "records_of", "reference_for",
                 "request_flops", "CHECK_NAMES", "program_numbers"):
        setattr(module, name, globals()[name])
    monkeypatch.setitem(sys.modules, NAME, module)
    return importlib.import_module(NAME)


WORKLOAD = dict(name="squares.tiny", config="squares", loop=NAME.rsplit(".", 1)[1],
                point={}, check=dict(requests=2, limits=dict(max_abs=1e-5)))


def _bench():
    bench = cells.load_benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("image_request_s", "mfu.image"):
            m["workloads"] = m["workloads"] + [WORKLOAD["name"]]
    return bench


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("broken", [False, True])
def test_a_loop_brings_its_own_models_count_and_check(loop, trace, broken, capsys):
    args = types.SimpleNamespace(workload=WORKLOAD["name"], seed=2 ** 33 + 5, seconds=0.2,
                                 trace=trace, cell_kwargs=dict(broken=broken))
    assert run.execute(args, _bench(), WORKLOAD, {}, loop, torch.device("cpu")) == 0
    out = capsys.readouterr()
    result = json.loads(out.out.strip().splitlines()[-1])
    assert result["correct"] is (not broken)
    assert list(result["checks"]) == ["max_abs"] and list(result)[-1] == "checks"
    assert result["checks"]["max_abs"]["limit"] == 1e-5
    assert out.err.strip().splitlines()[-1].startswith("check max_abs ")
    if trace:
        assert set(result["metrics"]) == {"mfu.image"}
        assert f"model operations a span: {json.dumps(request_flops({}, {}))}" in out.err
        assert result["metrics"]["mfu.image"]["value"] > 0
    else:
        assert set(result["metrics"]) == {"image_request_s", "setup_s"}


def test_limits_that_name_other_numbers_stop_the_run(loop, capsys):
    wl = dict(WORKLOAD, check=dict(requests=2, limits=dict(max_abs=1e-5, unet_rel_l2=0.1)))
    args = types.SimpleNamespace(workload=wl["name"], seed=3, seconds=0.1, trace=0)
    assert run.execute(args, _bench(), wl, {}, loop, torch.device("cpu")) == 4
    out = capsys.readouterr()
    assert not out.out.strip() and "compares ['max_abs']" in out.err
