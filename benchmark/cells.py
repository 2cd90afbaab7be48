"""Cells, configurations and metrics, found by name.

A cell is ``workloads/<name>.json``, its configuration
``configs/<config>.json``, and every metric a reader of its own,
``metrics/<metric>.py``, whose ``read(run)`` returns a number or None (None:
nothing to read in this run, and the metric is left out of the result). Which
metrics a cell reports is ``BENCHMARK.json``'s: its end-to-end metrics with
``--trace 0`` and its per-layer metrics with ``--trace 1``, each where its
``workloads`` list names the cell or where it has no such list.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict, List

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def load_workload(name: str, bench_dir: str = BENCH_DIR) -> dict:
    path = os.path.join(bench_dir, "workloads", f"{name}.json")
    if not os.path.isfile(path):
        raise KeyError(f"no cell {name!r}: {path} does not exist")
    return _json(path)


def load_config(name: str, bench_dir: str = BENCH_DIR) -> dict:
    path = os.path.join(bench_dir, "configs", f"{name}.json")
    if not os.path.isfile(path):
        raise KeyError(f"no configuration {name!r}: {path} does not exist")
    return _json(path)


def metric_reader(name: str, bench_dir: str = BENCH_DIR) -> Callable:
    """``read`` of metrics/<name>.py (a name may hold dots, so the file is
    loaded by its path)."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    if not os.path.isfile(path):
        raise KeyError(f"no reader for metric {name!r}: {path} does not exist")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_for(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The entries of BENCHMARK.json this cell reports in this kind of run."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]


def read_metrics(entries: List[dict], run, bench_dir: str = BENCH_DIR) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of every entry whose reader finds a value."""
    out = {}
    for m in entries:
        value = metric_reader(m["name"], bench_dir)(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
