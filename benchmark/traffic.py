"""The one traffic generator: a workload file's answer template filled with
tagged spans whose captions are drawn from its caption list by the seed and
the request's index. Every caption pads to the text encoder's 77 tokens, so
each seed gives the same work in another order."""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from benchmark.cells import BENCH_DIR
from benchmark.weights import derive_seed


def captions(workload: dict, bench_dir: str = BENCH_DIR) -> List[str]:
    with open(os.path.join(bench_dir, workload["captions"])) as f:
        return [line.strip() for line in f if line.strip()]


def answer(workload: dict, pool: List[str], seed: int, index: int) -> Tuple[str, List[str]]:
    """(the tagged answer text of request `index`, its span captions)."""
    rng = np.random.default_rng(derive_seed(seed, index, 3))
    caps = [pool[i] for i in rng.choice(len(pool), workload["spans_per_answer"], replace=False)]
    tag = workload["modality"]
    spans = " ".join(f"<{tag}>{c}</{tag}>" for c in caps)
    return workload["answer_template"].format(spans=spans), caps
