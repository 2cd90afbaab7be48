#!/usr/bin/env python3
"""Host time of one UNet call of a benchmark cell, in one or more checkouts,
on one NVIDIA GPU.

    python3 tools/unet_host_cost.py [--workload sd15.image] [--calls 60] [ROOT ...]

For each ROOT (a checkout of this repository; default: the one this file is
in) a fresh process imports that tree's ``benchmark`` and ``spider_tpu_torch``,
sets up the cell as the benchmark does (its pipeline, weights from the seed),
serves one request at the cell's shapes and keeps the arguments of its first
UNet call (the classifier-free-guidance batch). It then times that UNet call
`--calls` times on the host, from the call to its return, with a synchronise
before each, so that every call starts on an empty launch queue: the host's
cost of launching one call's kernels. Where the tree records the program's
spans (``profiler.recording``), the same is timed again with recording on,
and the cost of the spans with recording off is bounded directly: one
request is recorded to count its spans and launch records, and the host's
cost of one ``span()`` block and of one ``recording_on()`` test, recording
off, is timed over many calls (``off_bound_ms``: spans x the one plus
launches x the other, a request).
To compare two commits, name both roots in one call, twice, in turns
(parent, change, change, parent): host times move between machines and
between minutes. Prints one JSON line a root with the card's name and power
limit, and the median, 10th and 90th percentile in milliseconds.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def host_ms(call, calls: int) -> dict:
    import torch

    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    deciles = statistics.quantiles(times, n=10)
    return dict(median=statistics.median(times), p10=deciles[0], p90=deciles[-1])


def measure(root: str, workload_name: str, calls: int, seed: int) -> dict:
    sys.path.insert(0, root)
    import torch

    from benchmark import cells
    from benchmark.loops import spider_decoder as D
    from spider_tpu_torch.common import profiler

    workload = cells.load_workload(workload_name)
    config = cells.load_config(workload["config"])
    dev = torch.device("cuda", 0)
    cell = D.Cell(workload, config, seed, dev)
    unet, first = cell.pipe.unet, []

    class Keep:
        def __getattr__(self, name):
            return getattr(unet, name)

        def __call__(self, *a, **kw):
            if not first:
                first.append((a, kw))
            return unet(*a, **kw)

    cell.pipe.unet = Keep()
    cell.serve(-1)
    a, kw = first[0]
    module = cell.modules["unet"]

    def call():
        with torch.inference_mode():
            module(*a, **kw)

    for _ in range(5):
        call()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    out = dict(root=root, workload=workload_name, calls=calls, nvidia_smi=smi,
               off_ms=host_ms(call, calls), recording_ms=None)
    if hasattr(profiler, "recording"):
        with profiler.recording():
            out["recording_ms"] = host_ms(call, calls)
        out["spans_a_call"] = len(profiler.drain().spans) / calls
        with profiler.recording():
            cell.serve(0)
        rec = profiler.drain()
        out["off_span_us"] = off_us(lambda: profiler.span("unet", i=1))
        out["off_test_us"] = off_us(profiler.recording_on)
        out.update(spans_a_request=len(rec.spans), launches_a_request=len(rec.launches),
                   off_bound_ms=(len(rec.spans) * out["off_span_us"]
                                 + len(rec.launches) * out["off_test_us"]) / 1e3)
    return out


def off_us(make, n: int = 200_000) -> float:
    """Host microseconds of one ``with make():`` block (or one call of
    `make` where it returns no context), the median of five loops of `n`."""
    probe = make()
    loops = []
    for _ in range(5):
        t0 = time.perf_counter()
        if hasattr(probe, "__enter__"):
            for _ in range(n):
                with make():
                    pass
        else:
            for _ in range(n):
                make()
        loops.append((time.perf_counter() - t0) / n * 1e6)
    return statistics.median(loops)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="sd15.image")
    p.add_argument("--calls", type=int, default=60)
    p.add_argument("--seed", type=int, default=2 ** 31 + 19)
    p.add_argument("--measure", help=argparse.SUPPRESS)
    p.add_argument("roots", nargs="*")
    args = p.parse_args()
    if args.measure:
        print(json.dumps(measure(args.measure, args.workload, args.calls, args.seed)),
              flush=True)
        return 0
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rc = 0
    for root in [os.path.abspath(r) for r in args.roots] or [here]:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", root,
                               "--workload", args.workload, "--calls", str(args.calls),
                               "--seed", str(args.seed)], cwd=root)
        rc |= proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
