"""GPipe over the ranks of a group (counterpart of
spider_tpu/parallel/pipeline.py): stage s of S runs on rank s, microbatch
activations flow stage to stage, and the (M + S - 1)-tick schedule fills
and drains the pipe. Every stage maps activations of one shape to the same
shape (uniform transformer stages).

Differentiable, as the JAX version is under jax AD: the hand-off to the
right neighbour is ``collectives.shift_right`` (its backward sends the
cotangent to the left), and the last stage's outputs reach every stage by
``sum_to_all``, a replicated value whose cotangent each rank takes as it is.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from spider_tpu_torch.parallel.collectives import rank_in, shift_right, size_of, sum_to_all


def gpipe(fn: Callable[[Any, torch.Tensor], torch.Tensor], stage_params: Any,
          microbatches: torch.Tensor, group=None) -> torch.Tensor:
    """Run ``fn(stage_params, x)`` as stage ``rank`` of the S ranks of
    `group` over microbatches [M, ...] (every rank passes the same ones;
    stage 0 reads them). Returns the last stage's outputs [M, ...] on every
    rank. At tick t stage 0 takes microbatch min(t, M - 1), every other
    stage the output its left neighbour made at tick t - 1, and the last
    stage emits microbatch t - (S - 1)."""
    S, idx = size_of(group), rank_in(group)
    M = microbatches.shape[0]
    prev = torch.zeros_like(microbatches[0])
    ys = []
    for t in range(M + S - 1):
        recv = shift_right(prev, group)
        # every rank keeps every hand-off and every output in its graph
        # (adding or multiplying by zero changes no bits), so each rank's
        # backward runs the same exchanges in the same order
        inp = microbatches[min(t, M - 1)] + 0 * recv if idx == 0 else recv
        out = fn(stage_params, inp)
        emit = idx == S - 1 and S - 1 <= t < S - 1 + M
        if t >= S - 1:
            ys.append(out if emit else out * 0)
        prev = out
    return sum_to_all(torch.stack(ys), group)
