"""Loader utilities: the framework-free part of
spider_tpu/datasets/utils/loaders.py, copied.

  * MultiIterLoader: ratio-weighted mixing of multiple sources, every draw
    from one seeded RNG stream, so the choice is reproducible.
  * batched / collate_samples: sample dicts -> batch dicts.

The device-prefetch loader of the reference waits for the multi-card slice.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np


class MultiIterLoader:
    """Draw each batch from one of `loaders`, picked with probability
    proportional to `ratios` from a deterministic shared RNG."""

    def __init__(self, loaders: Sequence[Iterable],
                 ratios: Optional[Sequence[float]] = None, seed: int = 42):
        if not loaders:
            raise ValueError("MultiIterLoader needs at least one loader")
        if ratios is None:
            ratios = [1.0] * len(loaders)
        ratios = np.asarray(ratios, np.float64)
        self._p = ratios / ratios.sum()
        self._iters = [iter(l) for l in loaders]
        self._rng = np.random.default_rng(seed)

    def __iter__(self):
        return self

    def __next__(self):
        idx = int(self._rng.choice(len(self._iters), p=self._p))
        return next(self._iters[idx])


def collate_samples(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    """List of sample dicts -> batch dict: every value becomes a list (arrays
    stay separate arrays; ``Spider.prepare_batch`` stacks them)."""
    if not samples:
        raise ValueError("no samples to collate")
    out: Dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[key] = [np.asarray(v) for v in vals]
        else:
            out[key] = vals
    return out


def batched(loader: Iterable[Dict], batch_size: int) -> Iterator[Dict]:
    buf: List[Dict] = []
    for sample in loader:
        buf.append(sample)
        if len(buf) == batch_size:
            yield collate_samples(buf)
            buf = []
