"""The readings the limits of ``correct`` are set from, on the card, in one
process:

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 [--requests n]

For each seed: the cell's weights and traffic from that seed, ``--requests``
requests (by default the check's sample size) through the timed path
(``SpiderDecoder.generate`` at the cell's shapes), then the check's numbers
of those requests against the fp32 reference (the lower readings: the
program's) and of the reference computed in fp8 in the program's place at the
same inputs (the upper readings: the control's). One JSON line a seed, then
one with the largest program reading and the smallest control reading of
each number. The benchmark's own runs do not run this.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse  # noqa: E402
import json  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated whole numbers")
    p.add_argument("--requests", type=int, default=None)
    args = p.parse_args(argv)
    import torch

    from benchmark import cells, check
    from benchmark.loops import spider_decoder as D

    if not torch.cuda.is_available():
        print("control.py needs a CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    workload = cells.load_workload(args.workload)
    config = cells.load_config(workload["config"])
    n = args.requests or workload["check"]["requests"]
    device = torch.device("cuda", 0)
    cell = D.Cell(workload, config, seeds[0], device)
    D.warm_up(cell)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = None
    program_max, control_min = {}, {}
    for seed in seeds:
        cell.reseed(seed)
        t0 = time.perf_counter()
        for i in range(n):
            cell.serve(i)
        served_s = time.perf_counter() - t0
        records = D.records_of(cell, list(range(n)))
        values = D.reference_values(cell)
        if ref is None:
            ref = check.Reference(config, workload, values, device)
        else:
            ref.load(values)
        del values
        t0 = time.perf_counter()
        prog = check.program_numbers(ref, records)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        ctrl = check.control_numbers(ref, records)
        for k, v in prog.items():
            program_max[k] = max(program_max.get(k, v), v)
        for k, v in ctrl.items():
            control_min[k] = min(control_min.get(k, v), v)
        print(json.dumps(dict(seed=seed, program=prog, control=ctrl, served_s=served_s,
                              reference_s=ref_s)), flush=True)
    print(json.dumps(dict(workload=args.workload, seeds=len(seeds), requests=n,
                          program_max=program_max, control_min=control_min,
                          card=torch.cuda.get_device_name(device))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
