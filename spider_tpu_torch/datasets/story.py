"""Story builders (a copy of spider_tpu/datasets/story.py): pororo and
flintstones, 5-frame stories read from an HDF5 file (``hdf5_path``, through
``backends.Hdf5Story``) or from the synthetic twin."""

from __future__ import annotations

import random
from typing import Dict

import numpy as np

from spider_tpu_torch.common.registry import registry
from spider_tpu_torch.datasets import backends
from spider_tpu_torch.datasets.base import BaseBuilder, MapSampleDataset, pick
from spider_tpu_torch.processors.text import text_processor
from spider_tpu_torch.processors.vision import clip_image_transform

STORY_POOL = [
    "Continue the story: {}",
    "Tell the rest of this story: {}",
    "Given the first scene {} describe the whole story",
    "What happens next in this story: {}",
    "Please narrate the story that starts with {}",
]


class StoryDataset(MapSampleDataset):
    def __init__(self, build_info: Dict, seed: int = 0):
        self.build_info = build_info
        self.rng = random.Random(seed)
        if build_info.get("hdf5_path"):
            source = backends.Hdf5Story(build_info["hdf5_path"],
                                        build_info.get("image_key", "image"),
                                        build_info.get("text_key", "text"))
        else:
            source = backends.SyntheticStory(
                size=build_info.get("synthetic_size", 64), seed=seed,
                length=build_info.get("num_samples", 32))
        super().__init__(source, self._to_dict)

    def _to_dict(self, index: int, rec: Dict) -> Dict:
        frames = rec["images"]                   # [5, H, W, 3]
        texts = [text_processor(t) for t in rec["texts"]]
        images = [clip_image_transform(f, 224) for f in frames]
        text_all = "|".join(texts)
        instruction = pick(self.rng, STORY_POOL).format(texts[0])
        return {
            "Question": f"<IMAGE><IMAGE-Placeholder></IMAGE> {instruction} ",
            "TaskPrompt": "[STORY]",
            "Answer": text_all,
            "IMAGE": np.repeat(images[0][:, None], 2, axis=1),  # 2-frame tube
            "images": images,
            "texts": texts,
        }


@registry.register_builder("pororo")
class PororoBuilder(BaseBuilder):
    def build_datasets(self):
        return StoryDataset(self.build_info,
                            seed=self.build_info.get("seed", 0))


@registry.register_builder("flintstones")
class FlintstonesBuilder(BaseBuilder):
    def build_datasets(self):
        return StoryDataset(self.build_info,
                            seed=self.build_info.get("seed", 1))
