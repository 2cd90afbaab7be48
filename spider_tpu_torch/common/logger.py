"""Host-side metric logging: ``MetricLogger``, ``SmoothedValue`` and
``setup_logger`` (counterpart of spider_tpu/common/logger.py). Across the
ranks of a process group, ``synchronize_between_processes`` sums each
meter's (count, total) in float64; ``setup_logger`` writes log.txt and logs
below WARNING on rank 0 only.
"""

from __future__ import annotations

import datetime
import logging
import sys
import time
from collections import defaultdict, deque
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from spider_tpu_torch.common import dist


class SmoothedValue:
    """Track a series of values; expose window and global averages."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1) -> None:
        value = float(value)
        self.deque.append(value)
        self.count += n
        self.total += value * n

    def synchronize_between_processes(self) -> None:
        """Sum count and total over every rank (float64 all_reduce); the
        window stays this rank's."""
        if dist.get_world_size() == 1:
            return
        backend = torch.distributed.get_backend()
        t = torch.tensor([self.count, self.total], dtype=torch.float64,
                         device="cuda" if backend == "nccl" else "cpu")
        torch.distributed.all_reduce(t)
        self.count, self.total = int(t[0].item()), float(t[1].item())

    @property
    def median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self) -> str:
        return self.fmt.format(
            median=self.median,
            avg=self.avg,
            global_avg=self.global_avg,
            max=self.max,
            value=self.value,
        )


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            if v is None:
                continue
            if hasattr(v, "item"):
                v = float(v.item()) if np.ndim(v) == 0 else float(np.mean(v))
            self.meters[k].update(float(v))

    def __getattr__(self, attr: str):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(f"'MetricLogger' object has no attribute '{attr}'")

    def __str__(self) -> str:
        return self.delimiter.join(f"{name}: {meter}" for name, meter in self.meters.items())

    def synchronize_between_processes(self) -> None:
        for meter in self.meters.values():
            meter.synchronize_between_processes()

    def add_meter(self, name: str, meter: SmoothedValue) -> None:
        self.meters[name] = meter

    def global_avg(self) -> str:
        return self.delimiter.join(
            f"{name}: {meter.global_avg:.4f}" for name, meter in self.meters.items()
        )

    def log_every(self, iterable: Iterable, print_freq: int, header: Optional[str] = None):
        """Yield from iterable, logging every `print_freq` with ETA."""
        header = header or ""
        i = 0
        start_time = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        try:
            total = len(iterable)  # type: ignore[arg-type]
        except TypeError:
            total = None
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or (total and i == total - 1):
                if total:
                    eta_seconds = iter_time.global_avg * (total - i)
                    eta_string = str(datetime.timedelta(seconds=int(eta_seconds)))
                    logging.info(
                        "%s [%*d/%d]  eta: %s  %s  time: %s  data: %s",
                        header, len(str(total)), i, total, eta_string,
                        self, iter_time, data_time,
                    )
                else:
                    logging.info("%s [%d]  %s  time: %s  data: %s",
                                 header, i, self, iter_time, data_time)
            i += 1
            end = time.time()
        total_time = time.time() - start_time
        logging.info("%s Total time: %s (%.4f s / it)",
                     header, str(datetime.timedelta(seconds=int(total_time))),
                     total_time / max(i, 1))


def setup_logger(output_dir: Optional[str] = None, level=logging.INFO) -> None:
    """Logging to the stream and, on rank 0 given `output_dir`, to its
    log.txt; ranks other than 0 log WARNING and above."""
    main = dist.is_main_process()
    handlers = [logging.StreamHandler(sys.stdout)]
    if output_dir and main:
        import os

        os.makedirs(output_dir, exist_ok=True)
        handlers.append(logging.FileHandler(f"{output_dir}/log.txt"))
    logging.basicConfig(
        level=level if main else logging.WARNING,
        format="%(asctime)s [%(levelname)s] %(message)s",
        handlers=handlers,
        force=True,
    )
