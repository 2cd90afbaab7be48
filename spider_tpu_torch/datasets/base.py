"""Dataset builder protocol (a copy of spider_tpu/datasets/base.py).

Builders register under their names and produce iterables of sample dicts:
  {Question, TaskPrompt, Answer, Caption, IMAGE/VIDEO/AUDIO/MASK/BOX,
   Meta_info, ...}
The config carries `build_info` (paths or `synthetic=True`).
"""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, Iterator, List, Optional


class IterableSampleDataset:
    """Wraps a source iterable with a to_dict transform (webdataset-pipeline
    analogue); infinite unless the source stops."""

    def __init__(self, source, to_dict: Callable[[Dict], Optional[Dict]],
                 seed: int = 0):
        self.source = source
        self.to_dict = to_dict
        self.seed = seed

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        for raw in self.source:
            try:
                sample = self.to_dict(raw)
            except Exception:
                continue  # warn_and_continue semantics
            if sample is not None:
                yield sample


class MapSampleDataset:
    """Map-style dataset over an indexable source."""

    def __init__(self, source, to_dict: Callable[[int, Any], Dict]):
        self.source = source
        self.to_dict = to_dict

    def __len__(self):
        return len(self.source)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        return self.to_dict(index, self.source[index])

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


class BaseBuilder:
    """cfg.build_info: synthetic=True|False, plus backend paths."""

    train_dataset_cls = None

    def __init__(self, cfg=None):
        self.config = cfg or {}

    @property
    def build_info(self) -> Dict[str, Any]:
        info = self.config.get("build_info", {}) if hasattr(self.config, "get") \
            else getattr(self.config, "build_info", {})
        return dict(info)

    def build_datasets(self):
        raise NotImplementedError


def pick(rng: random.Random, pool: List[str]) -> str:
    return pool[rng.randrange(len(pool))]
