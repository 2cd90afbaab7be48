"""Host-side metric logging: ``MetricLogger``, ``SmoothedValue`` and
``setup_logger`` (counterpart of spider_tpu/common/logger.py). One process:
the cross-process sums of the reference wait for the multi-card slice.
"""

from __future__ import annotations

import datetime
import logging
import sys
import time
from collections import defaultdict, deque
from typing import Dict, Iterable, Optional

import numpy as np


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
    """Logging to the stream and, given `output_dir`, to its log.txt."""
    handlers = [logging.StreamHandler(sys.stdout)]
    if output_dir:
        import os

        os.makedirs(output_dir, exist_ok=True)
        handlers.append(logging.FileHandler(f"{output_dir}/log.txt"))
    logging.basicConfig(
        level=level,
        format="%(asctime)s [%(levelname)s] %(message)s",
        handlers=handlers,
        force=True,
    )
