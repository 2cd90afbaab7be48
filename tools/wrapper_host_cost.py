#!/usr/bin/env python3
"""Host cost of the two serving wrappers of one checkout, on one NVIDIA GPU.

    python3 tools/wrapper_host_cost.py [ROOT ...]

For each ROOT (a checkout of this repository; default: the one this file is
in) a fresh process imports that tree's ``spider_tpu_torch``, builds its int4
and paged kernels, and times ``int4_matmul_kernel`` (16 rows, and 128 rows) and
``paged_decode_kernel`` with the loop ``chip_smoke.py`` prints as
``wrapper_us``: 1000 calls queued one behind the other, no synchronise inside,
at shapes so small that the card keeps up; host microseconds a call. To compare
two commits, name both roots in one call, twice, in turns (parent, change,
change, parent): host times move between machines and between minutes.
Prints one JSON line a root with the card's name and power limit.
"""

import json
import os
import subprocess
import sys
import time

CALLS = 1000


def measure(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    from spider_tpu_torch.ops import paged_attention as PA
    from spider_tpu_torch.ops import quant as Q

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(470)

    def int4_case(M):
        x = torch.randn((M, 512), generator=g, device=dev, dtype=torch.bfloat16)
        packed = torch.randint(-128, 128, (64, 256), generator=g, device=dev, dtype=torch.int8)
        return x, packed, torch.full((64,), 0.01, device=dev)

    x16, packed, scale = int4_case(16)
    x128 = int4_case(128)[0]
    q = torch.randn((2, 8, 64), generator=g, device=dev, dtype=torch.bfloat16)
    pk, pv = (torch.randn((9, 16, 2, 64), generator=g, device=dev, dtype=torch.bfloat16)
              for _ in range(2))
    table = torch.arange(1, 9, device=dev, dtype=torch.int32).reshape(2, 4)
    lens = torch.tensor([5, 60], dtype=torch.int32, device=dev)

    def host_us(call):
        for _ in range(20):
            call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            call()
        seconds = time.perf_counter() - t0
        torch.cuda.synchronize()
        return seconds / CALLS * 1e6

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    return dict(root=root, calls=CALLS, nvidia_smi=smi,
                int4_M16_us=host_us(lambda: Q.int4_matmul_kernel(x16, packed, scale)),
                int4_M128_us=host_us(lambda: Q.int4_matmul_kernel(x128, packed, scale)),
                paged_us=host_us(lambda: PA.paged_decode_kernel(q, pk, pv, table, lens)))


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--measure":
        print(json.dumps(measure(sys.argv[2])), flush=True)
        return 0
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    roots = [os.path.abspath(r) for r in sys.argv[1:]] or [here]
    rc = 0
    for root in roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", root],
                              cwd=root)
        rc |= proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
