"""Run one cell of the benchmark once, on the card this process finds.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints, as the last line of standard output, one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each number the comparison holds against its limit (also the
last lines of standard error). With ``--trace 1`` standard error also holds
the profiled request's ``idle by span`` and ``device by span`` tables. Exits
2 without a result where CUDA is missing or the cell wants more cards than
there are, 3 where the process holds JAX or the JAX package once the window
has closed, and 4 where the workload's ``check.limits`` do not name exactly
the loop's check numbers.

The cell's loop module (``loops/<loop>.py``) drives the program and brings
its configuration's own models to the count and the comparison:
``Cell(workload, config, seed, device, trace=...)``, ``warm_up(cell)``,
``run_window(cell, seconds)``, ``check_sample``, ``records_of``,
``reference_for(cell)``, ``request_flops(config, point)``,
``program_numbers(ref, records)`` and ``CHECK_NAMES``.
"""

from __future__ import annotations

import os
import sys
import time

_T0 = time.perf_counter()


def _process_age_s() -> float:
    """Seconds since this process started, by the kernel's clock."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE_AT_T0 = _process_age_s()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# Caches a library may write go to fixed places inside the checkout.
os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, "build_cache", "triton")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(HERE, "build_cache", "inductor")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "spider_tpu")


def forbidden_modules() -> list:
    """Top-level names of sys.modules, compared whole, that are JAX or the
    JAX package."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "unknown"


class Run:
    """What the metric readers read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark import cells

    bench = cells.load_benchmark()
    workload = cells.load_workload(args.workload)
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"BENCHMARK.json has no cell {args.workload!r}", file=sys.stderr)
        return 2
    config = cells.load_config(workload["config"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"cell {args.workload} needs {entry['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import importlib

    loop = importlib.import_module(f"benchmark.loops.{workload['loop']}")
    return execute(args, bench, workload, config, loop, torch.device("cuda", 0))


def execute(args, bench, workload, config, loop, device) -> int:
    """Set-up, warm-up, window, check, result: everything but the look for
    a card (the tests drive it on the CPU)."""
    import torch

    from benchmark import cells, check, profiling

    names = tuple(loop.CHECK_NAMES)
    limits = workload["check"]["limits"]
    if set(limits) != set(names):
        print(f"cell {workload['name']}: check.limits name {sorted(limits)}, but its loop "
              f"{workload['loop']!r} compares {sorted(names)}", file=sys.stderr)
        return 4
    trace = bool(args.trace)
    smi = power_limit() if device.type == "cuda" else "cpu"
    cell = loop.Cell(workload, config, args.seed, device, trace=trace,
                       **getattr(args, "cell_kwargs", {}))
    warm_s = loop.warm_up(cell)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - _T0 + _AGE_AT_T0
    window = loop.run_window(cell, args.seconds)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    found = forbidden_modules()
    if found:
        print(f"the process holds {', '.join(found)} after the window", file=sys.stderr)
        return 3
    completed = [i for i in range(window["attempted"]) if i not in window["failed_requests"]]
    sl = window["slice"]
    run = Run(workload=workload, config=config, window=window, setup_s=setup_s,
              spans=cell.spans.by_request if trace else None, slice=sl,
              flops=loop.request_flops(config, workload["point"]) if trace else None)
    metrics = cells.read_metrics(cells.metrics_for(bench, workload["name"], trace), run)

    sample = loop.check_sample(workload, args.seed, completed)
    records = loop.records_of(cell, sample)
    cell.free_program()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = loop.reference_for(cell)
    numbers = loop.program_numbers(ref, records)
    correct = check.verdict(numbers, limits) and window["failed"] == 0 and bool(records)
    checks = {n: {"value": numbers[n], "limit": limits[n]} for n in names}

    dev = dict(platform="gpu" if device.type == "cuda" else device.type,
               kind=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
               count=1, memory_peak_bytes=int(peak), power_limit=smi)
    result = dict(correct=bool(correct), attempted=window["attempted"],
                  failed=window["failed"], metrics=metrics, device=dev)
    p = profiling.profiled(run) if trace else None
    if trace and sl is not None:
        dev["busy_s"] = sl.busy_s()
        dev["window_s"] = sl.wall_s
        result["breakdown"] = dict(device_ops=sl.device_ops(), idle_gaps=sl.idle_gaps(p))
    result["checks"] = checks
    print(f"cell {workload['name']} seed {args.seed}: set-up {setup_s:.3f} s (warm-up request "
          f"{warm_s:.3f} s), {window['attempted']} requests in {window['window_s']:.3f} s, "
          f"peak {peak} bytes, card {smi}", file=sys.stderr)
    print("latencies s: " + " ".join(f"{x:.4f}" for x in window["latencies"]), file=sys.stderr)
    if trace and run.flops is not None:
        print(f"model operations a span: {json.dumps(run.flops)}", file=sys.stderr)
    if p is not None:
        print("idle by span (s): " + "; ".join(
            f"{n} {sec:.6f}" for n, sec in profiling.idle_by_span(p)), file=sys.stderr)
        print("device by span (s, ops): " + "; ".join(
            f"{n} {sec:.6f} {c}" for n, sec, c in profiling.device_by_span(p)), file=sys.stderr)
        print("collections in the profiled request (s): " + " ".join(
            f"{(e - s) / 1e9:.6f}" for s, e in sl.collections), file=sys.stderr)
    for n in names:
        print(f"check {n} {numbers[n]!r} limit {limits[n]!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
