"""The readings the story cell's limits of ``correct`` are set from, on the
card, in one process:

    python3 benchmark/control_story.py --workload sdxl_story.story --seeds 11,12,13 \
        [--requests n] [--self-only-seeds k]

For each seed: the cell's weights and traffic from that seed, ``--requests``
requests (by default the check's sample size) through the timed path
(``SpiderDecoderInfer`` at the cell's point), then the check's numbers of
those requests against the fp32 reference (the lower readings: the
program's) and of the reference computed in fp8 in the program's place at the
same inputs (the upper readings: the fp8 control's). For the first
``--self-only-seeds`` seeds, the same requests again with the program's bank
dropped (``story_bank_config("self_only")``) and their numbers (a second
upper reading). One JSON line a seed, then one with the largest program
reading and the smallest control readings of each number. The benchmark's
own runs do not run this.
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
    p.add_argument("--self-only-seeds", type=int, default=3)
    args = p.parse_args(argv)
    import torch

    from benchmark import cells
    from benchmark.loops import story as S
    from spider_tpu_torch.models.unet2d import story_bank_config

    if not torch.cuda.is_available():
        print("control_story.py needs a CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    workload = cells.load_workload(args.workload)
    config = cells.load_config(workload["config"])
    n = args.requests or workload["check"]["requests"]
    device = torch.device("cuda", 0)
    cell = S.Cell(workload, config, seeds[0], device)
    S.warm_up(cell)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = None
    low, high = {}, {"fp8": {}, "self_only": {}}

    def serve_and_check(bank_dropped: bool):
        t0 = time.perf_counter()
        for i in range(n):
            if bank_dropped:
                with story_bank_config("self_only"):
                    cell.serve(i)
            else:
                cell.serve(i)
        served_s = time.perf_counter() - t0
        records = S.records_of(cell, list(range(n)))
        t0 = time.perf_counter()
        numbers = S.program_numbers(ref, records)
        torch.cuda.synchronize()
        return records, numbers, served_s, time.perf_counter() - t0

    for k, seed in enumerate(seeds):
        cell.reseed(seed)
        values = S.reference_values(cell)
        if ref is None:
            ref = S.Reference(config, workload, values, device)
        else:
            ref.load(values)
        del values
        records, prog, served_s, ref_s = serve_and_check(False)
        line = dict(seed=seed, program=prog, fp8=S.control_numbers(ref, records),
                    served_s=served_s, reference_s=ref_s)
        for name, v in prog.items():
            low[name] = max(low.get(name, v), v)
        controls = [("fp8", line["fp8"])]
        if k < args.self_only_seeds:
            _, line["self_only"], _, _ = serve_and_check(True)
            controls.append(("self_only", line["self_only"]))
        for kind, numbers in controls:
            for name, v in numbers.items():
                high[kind][name] = min(high[kind].get(name, v), v)
        print(json.dumps(line), flush=True)
    print(json.dumps(dict(workload=args.workload, seeds=len(seeds), requests=n,
                          program_max=low, fp8_min=high["fp8"],
                          self_only_min=high["self_only"],
                          card=torch.cuda.get_device_name(device))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
