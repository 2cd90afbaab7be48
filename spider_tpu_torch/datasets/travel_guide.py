"""Travel-guide builder (a copy of spider_tpu/datasets/travel_guide.py):
text-only many-modal answers from JSON guides (``json_path``) whose answers
embed <IMAGE>/<VIDEO>/<AUDIO> tag spans, TaskPrompt SMARTMULTIMODAL; two
built-in guides stand in when no file is given."""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List

from spider_tpu_torch.common.registry import registry
from spider_tpu_torch.datasets.base import BaseBuilder, MapSampleDataset, pick

GUIDE_POOL = [
    "Please provide travel guide for {}",
    "Give me a travel guide for {}",
    "I want to visit {}, what should I know",
    "Plan a trip to {}",
    "What are the highlights of {}",
]

_SYNTHETIC_GUIDES = [
    dict(location="Beijing", answer_multimodal=dict(
        introduction="Beijing, the capital of China.",
        must_see_attractions=[
            "The Great Wall<IMAGE>The Great Wall of China</IMAGE>: iconic.",
            "Forbidden City<IMAGE>The Forbidden City</IMAGE>: a vast palace.",
        ],
        cultural_experiences=[
            "Dragon Dance<VIDEO>Dragon Dance</VIDEO>: traditional dance.",
            "Peking Opera<AUDIO>Peking Opera</AUDIO>: classic opera.",
        ],
        food="Peking Duck<IMAGE>Peking Duck</IMAGE>: a famous dish.")),
    dict(location="Paris", answer_multimodal=dict(
        introduction="Paris, the capital of France.",
        must_see_attractions=[
            "Eiffel Tower<IMAGE>Eiffel Tower</IMAGE>: the landmark.",
        ],
        cultural_experiences=[
            "Street accordion<AUDIO>French accordion music</AUDIO>.",
        ],
        food="Croissant<IMAGE>Croissant</IMAGE>: fresh pastry.")),
]


class TravelGuideDataset(MapSampleDataset):
    def __init__(self, entries: List[Dict], seed: int = 0):
        self.rng = random.Random(seed)
        super().__init__(entries, self._to_dict)

    def _to_dict(self, index: int, entry: Dict) -> Dict:
        location = entry["location"]
        content = entry["answer_multimodal"]
        question = pick(self.rng, GUIDE_POOL).format(location)
        parts = []
        for section, details in content.items():
            title = section.replace("_", " ").title()
            if isinstance(details, list):
                body = "\n".join(f" - {item}" for item in details)
            else:
                body = details
            parts.append(f"{title}:\n{body}")
        return {
            "Question": question,
            "TaskPrompt": "[SMARTMULTIMODAL]",
            "Answer": "\n".join(parts),
            "Location": location,
        }


@registry.register_builder("travel_guide")
class TravelGuideBuilder(BaseBuilder):
    def build_datasets(self):
        path = self.build_info.get("json_path")
        if path and os.path.exists(path):
            with open(path) as f:
                entries = json.load(f)
        else:
            entries = _SYNTHETIC_GUIDES
        return TravelGuideDataset(entries,
                                  seed=self.build_info.get("seed", 0))
