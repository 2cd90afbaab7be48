"""X->T (captioning) and X->Ts builders: i2t_cc_sbu, v2t_webvid, a2t_audiocap
and their *_ts variants (a copy of spider_tpu/datasets/x2text.py)."""

from __future__ import annotations

import random
from typing import Dict, Optional

from spider_tpu_torch.common.registry import registry
from spider_tpu_torch.datasets.base import BaseBuilder, IterableSampleDataset, pick
from spider_tpu_torch.datasets.text2x import (KIND_WORD, TS_POOL, _prep_modality,
                                              _source)
from spider_tpu_torch.processors.text import text_processor

X2T_POOL = {
    "IMAGE": [
        "Describe this image",
        "What is this image",
        "Please generate a caption for this image",
        "Could you provide a descriptive caption for this image",
        "I need your help in generating a caption for this image",
        "Could you describe this image for me",
        "I would like you to generate a caption for this image",
        "Please provide a descriptive caption for this image",
    ],
    "VIDEO": [
        "Describe this video",
        "What is happening in this video",
        "Please generate a caption for this video",
        "Could you provide a descriptive caption for this video",
        "Could you describe this video for me",
        "I would like you to generate a caption for this video",
    ],
    "AUDIO": [
        "Describe this audio",
        "What can you hear in this audio",
        "Please generate a caption for this audio",
        "Could you provide a descriptive caption for this audio",
        "Could you describe this audio for me",
        "I would like you to generate a caption for this audio",
    ],
}


class X2TDataset(IterableSampleDataset):
    """X -> text caption (TaskPrompt [TEXT])."""

    def __init__(self, modality: str, build_info: Dict, seed: int = 0):
        self.modality = modality
        self.build_info = build_info
        self.rng = random.Random(seed)
        super().__init__(_source(build_info, modality, seed), self._to_dict,
                         seed)

    def _to_dict(self, raw) -> Optional[Dict]:
        caption = text_processor(raw["txt"])
        tensor = _prep_modality(raw, self.modality, self.build_info)
        if tensor is None:
            return None
        m = self.modality
        instr = pick(self.rng, X2T_POOL[m])
        return {
            "Question": f"<{m}><{m}-Placeholder></{m}> {instr} ",
            "TaskPrompt": "[TEXT]",
            "Answer": caption,
            m: tensor,
            "Caption": caption,
        }


class X2TTsDataset(IterableSampleDataset):
    """X input -> any-to-many output (TaskPrompt [SMARTMULTIMODAL]): the
    question carries the input placeholder AND a generation prompt_text whose
    tags drive the answer spans (i2t_ts_cc_sbu.py:45-85)."""

    def __init__(self, modality: str, build_info: Dict, seed: int = 0):
        self.modality = modality
        self.build_info = build_info
        self.rng = random.Random(seed)
        super().__init__(_source(build_info, modality, seed), self._to_dict,
                         seed)

    def _to_dict(self, raw) -> Optional[Dict]:
        caption = text_processor(raw["txt"])
        tensor = _prep_modality(raw, self.modality, self.build_info)
        if tensor is None:
            return None
        m_in = self.modality
        prompt_text = pick(self.rng, TS_POOL)
        question_instr = prompt_text
        answer_parts = []
        for m in ("IMAGE", "VIDEO", "AUDIO"):
            if f"<{m}>" in prompt_text:
                question_instr = question_instr.replace(f"<{m}>", KIND_WORD[m])
                answer_parts.append(f"<{m}>{caption}<{m}-Placeholder></{m}>")
        if not answer_parts:
            answer_parts = [f"<{m}>{caption}<{m}-Placeholder></{m}>"
                            for m in ("IMAGE", "VIDEO", "AUDIO")]
        return {
            "Question": f"<{m_in}><{m_in}-Placeholder></{m_in}> "
                        + question_instr.format(caption),
            "TaskPrompt": "[SMARTMULTIMODAL]",
            "Answer": caption + "".join(answer_parts),
            m_in: tensor,
            "Caption": caption,
        }


def _make_builder(name: str, dataset_cls, modality: str):
    @registry.register_builder(name)
    class Builder(BaseBuilder):
        def build_datasets(self):
            return dataset_cls(modality, self.build_info,
                               seed=self.build_info.get("seed", 0))

    Builder.__name__ = f"{name}_builder"
    return Builder


I2TCCSBUBuilder = _make_builder("i2t_cc_sbu", X2TDataset, "IMAGE")
V2TWebVidBuilder = _make_builder("v2t_webvid", X2TDataset, "VIDEO")
A2TAudioCapBuilder = _make_builder("a2t_audiocap", X2TDataset, "AUDIO")
I2TTsCCSBUBuilder = _make_builder("i2t_ts_cc_sbu", X2TTsDataset, "IMAGE")
V2TTsWebVidBuilder = _make_builder("v2t_ts_webvid", X2TTsDataset, "VIDEO")
A2TTsAudioCapBuilder = _make_builder("a2t_ts_audiocap", X2TTsDataset, "AUDIO")
