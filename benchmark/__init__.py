"""The benchmark of spider_tpu_torch on one NVIDIA H100: ``python3
benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
from the root of a checkout. See ``PERF.md`` and ``BENCHMARK.json``."""
