"""Learning-rate schedules, registered by name: plain Python functions of the
optimizer's step count (counterpart of spider_tpu/common/optims.py, where
they are optax schedules). Linear warmup followed by cosine or step decay,
and DeepSpeed's WarmupDecayLR.
"""

from __future__ import annotations

import math
from typing import Callable

from spider_tpu_torch.common.registry import registry

Schedule = Callable[[int], float]


@registry.register_lr_scheduler("linear_warmup_cosine_lr")
def linear_warmup_cosine_lr(init_lr: float, min_lr: float, warmup_steps: int,
                            total_steps: int, warmup_start_lr: float = -1.0,
                            **_unused) -> Schedule:
    warmup_start_lr = init_lr if warmup_start_lr < 0 else warmup_start_lr

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return warmup_start_lr + (init_lr - warmup_start_lr) * min(
                step / max(warmup_steps, 1), 1.0)
        t = min(max((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        return min_lr + 0.5 * (init_lr - min_lr) * (1.0 + math.cos(math.pi * t))

    return schedule


@registry.register_lr_scheduler("linear_warmup_step_lr")
def linear_warmup_step_lr(init_lr: float, min_lr: float, warmup_steps: int,
                          decay_rate: float = 0.9, steps_per_epoch: int = 1,
                          warmup_start_lr: float = -1.0, **_unused) -> Schedule:
    warmup_start_lr = init_lr if warmup_start_lr < 0 else warmup_start_lr

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return warmup_start_lr + (init_lr - warmup_start_lr) * min(
                step / max(warmup_steps, 1), 1.0)
        epoch = step // max(steps_per_epoch, 1)
        return max(init_lr * (decay_rate ** epoch), min_lr)

    return schedule


@registry.register_lr_scheduler("warmup_decay_lr")
def warmup_decay_lr(init_lr: float, warmup_steps: int, total_steps: int,
                    min_lr: float = 0.0, **_unused) -> Schedule:
    """DeepSpeed WarmupDecayLR: linear warmup, then linear decay to zero."""

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return init_lr * min(step / max(warmup_steps, 1), 1.0)
        t = min(max((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        return max(init_lr * (1.0 - t), min_lr)

    return schedule


def build_schedule(name: str, **kwargs) -> Schedule:
    fn = registry.get_lr_scheduler_class(name)
    if fn is None:
        raise KeyError(f"unknown lr scheduler '{name}'")
    return fn(**kwargs)
