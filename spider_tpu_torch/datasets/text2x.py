"""T->X and T->Ts (any-to-many) prompt builders (a copy of
spider_tpu/datasets/text2x.py, which is numpy and Python only).

Covers the t2i_cc_sbu / t2v_webvid / t2a_audiocap families and their *_ts
(SMARTMULTIMODAL), *_ts_mul and *_ts_spec (SPECIFICMULTIMODAL) variants. Data
arrives either from webdataset tar shards or from synthetic twins.
"""

from __future__ import annotations

import random
from typing import Dict, Optional

import numpy as np

from spider_tpu_torch.common.registry import registry
from spider_tpu_torch.datasets import backends
from spider_tpu_torch.datasets.base import BaseBuilder, IterableSampleDataset, pick
from spider_tpu_torch.processors.audio import audio_to_clips
from spider_tpu_torch.processors.text import text_processor
from spider_tpu_torch.processors.vision import image_to_imagebind
from spider_tpu_torch.processors.video import video_to_clips

# Single-modality generation prompts.
T2X_POOL = [
    "{}",
    "Generate {}",
    "Please generate an {kind} based on the following text: {}",
    "Could you create an {kind} from this text: {}",
    "I would like you to generate an {kind} based on this text: {}",
    "Please create an {kind} from the following text: {}",
    "Could you generate an {kind} based on this text: {}",
    "I need your help in creating an {kind} from this text: {}",
    "I would like you to create an {kind} from this text: {}",
]

# Any-to-many prompts: entries carrying explicit tags decide which
# modalities the answer contains (t2i_ts_cc_sbu.py:23-58).
TS_POOL = [
    "Generate {}",
    "Please generate {}",
    "Could you create {}",
    "I would like you to generate {}",
    "Please create {}",
    "Could you generate {}",
    "I need your help in creating {}",
    "I would like you to create {}",
    "Please generate the content based on the following text: {}",
    "Could you create the content from this text: {}",
    "I would like you to generate the content based on this text: {}",
    "Please create the content from the following text: {}",
    "Could you generate the content based on this text: {}",
    "I need your help in creating the content from this text: {}",
    "I would like you to create the content from this text: {}",
    "Please generate an <IMAGE> based on the following text: {}",
    "Please generate a <VIDEO> based on the following text: {}",
    "Please generate an <AUDIO> based on the following text: {}",
    "Please generate an <IMAGE> and a <VIDEO> based on the following text: {}",
    "Please generate an <IMAGE> and an <AUDIO> based on the following text: {}",
    "Please generate a <VIDEO> and an <AUDIO> based on the following text: {}",
    "Please generate an <IMAGE>, a <VIDEO>, and an <AUDIO> based on the following text: {}",
]

KIND_WORD = {"IMAGE": "image", "VIDEO": "video", "AUDIO": "audio"}


def _prep_modality(raw: Dict, modality: str, build_info: Dict):
    """Raw sample -> the modality tensor Spider's encoder expects."""
    if modality == "IMAGE":
        return image_to_imagebind(raw["jpg"],
                                  size=build_info.get("image_size", 224))
    if modality == "VIDEO":
        vid = raw["mp4"] if "mp4" in raw else raw["video"]
        if isinstance(vid, (bytes, bytearray)):  # source-level decode missed
            from spider_tpu_torch.datasets.media import decode_video_bytes

            vid = decode_video_bytes(bytes(vid))
            if vid is None:
                return None
        return video_to_clips(np.asarray(vid),
                              num_clips=build_info.get("num_clips", 5),
                              size=build_info.get("image_size", 224))
    if modality == "AUDIO":
        wav = raw["flac"] if "flac" in raw else raw["wav"]
        if isinstance(wav, (bytes, bytearray)):
            from spider_tpu_torch.datasets.media import decode_audio_bytes

            decoded = decode_audio_bytes(bytes(wav))
            if decoded is None:
                return None
            wav, raw = decoded[0], {**raw, "sample_rate": decoded[1]}
        return audio_to_clips(wav,
                              sample_rate=raw.get("sample_rate", 16000),
                              num_mels=build_info.get("num_mels", 128),
                              target_length=build_info.get("target_length", 204))
    raise KeyError(modality)


# per-modality member extensions a builder actually consumes: other members
# in mixed shards are skipped before decode (a video builder must not pay a
# FLAC decode per sample).
_MODALITY_EXTS = {
    "IMAGE": ("jpg", "jpeg", "png", "webp"),
    "VIDEO": ("mp4", "avi", "mov", "webm", "mkv", "jpg"),
    "AUDIO": ("flac", "wav", "mp3", "ogg"),
}


def _source(build_info: Dict, modality: str, seed: int):
    if build_info.get("webdataset_path"):
        return backends.TarShardSource(
            build_info["webdataset_path"], seed=seed,
            shuffle_buffer=build_info.get("shuffle_buffer", 1000),
            decode_exts=_MODALITY_EXTS.get(modality))
    size = build_info.get("synthetic_size", 64)
    if modality == "IMAGE":
        return backends.SyntheticImageText(size=size, seed=seed)
    if modality == "VIDEO":
        return backends.SyntheticVideoText(size=size, seed=seed)
    return backends.SyntheticAudioText(size=size, seed=seed)


class T2XDataset(IterableSampleDataset):
    """Text -> one modality (TaskPrompt [IMAGE]/[VIDEO]/[AUDIO])."""

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
        instr = pick(self.rng, T2X_POOL).replace("{kind}", KIND_WORD[m])
        return {
            "Question": instr.format(caption),
            "TaskPrompt": f"[{m}]",
            "Answer": f"<{m}>{caption}<{m}-Placeholder></{m}>",
            m: tensor,
            "Caption": caption,
        }


class T2XTsDataset(IterableSampleDataset):
    """Text -> any combination (TaskPrompt [SMARTMULTIMODAL]): the answer
    grows one tag span per modality the prompt_text names — or all three when
    it names none (t2i_ts_cc_sbu.py:66-99)."""

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
        prompt_text = pick(self.rng, TS_POOL)
        question = prompt_text
        answer_parts = []
        for m in ("IMAGE", "VIDEO", "AUDIO"):
            if f"<{m}>" in prompt_text:
                question = question.replace(f"<{m}>", KIND_WORD[m])
                answer_parts.append(f"<{m}>{caption}<{m}-Placeholder></{m}>")
        if not answer_parts:
            answer_parts = [f"<{m}>{caption}<{m}-Placeholder></{m}>"
                            for m in ("IMAGE", "VIDEO", "AUDIO")]
        return {
            "Question": question.format(caption),
            "TaskPrompt": "[SMARTMULTIMODAL]",
            "Answer": caption + "".join(answer_parts),
            self.modality: tensor,
            "Caption": caption,
        }


class T2XTsSpecDataset(IterableSampleDataset):
    """SPECIFICMULTIMODAL: question lists per-modality captions inside tags;
    answer repeats them with placeholders (t2v_ts_spec_webvid.py:185-226)."""

    def __init__(self, modality: str, build_info: Dict, seed: int = 0,
                 group: int = 5):
        self.modality = modality
        self.build_info = build_info
        self.group = group
        self.rng = random.Random(seed)
        self._pending = []
        super().__init__(_source(build_info, modality, seed), self._to_dict,
                         seed)

    def __iter__(self):
        captions, tensors = [], []
        for raw in self.source:
            captions.append(text_processor(raw["txt"]))
            tensors.append(_prep_modality(raw, self.modality, self.build_info))
            if len(captions) == self.group:
                sample = self._build(captions, tensors)
                captions, tensors = [], []
                if sample is not None:
                    yield sample

    def _build(self, captions, tensors):
        if tensors[0] is None:
            return None
        num = self.rng.randint(1, 5)
        mods = self.rng.sample(["IMAGE", "VIDEO", "AUDIO"],
                               min(num, 3))
        idxs = self.rng.sample(range(self.group), len(mods))
        q, a = "", ""
        for m, i in zip(mods, idxs):
            q += f"<{m}>{captions[i]}</{m}>."
            a += f"<{m}>{captions[i]} <{m}-Placeholder></{m}>."
        return {
            "Question": q.strip(),
            "TaskPrompt": "[SPECIFICMULTIMODAL]",
            "Answer": a.strip(),
            self.modality: tensors[0],
            "Caption": captions[0],
        }

    def _to_dict(self, raw):  # unused; __iter__ overridden
        raise NotImplementedError


def _make_builder(name: str, dataset_cls, modality: str):
    @registry.register_builder(name)
    class Builder(BaseBuilder):
        def build_datasets(self):
            return dataset_cls(modality, self.build_info,
                               seed=self.build_info.get("seed", 0))

    Builder.__name__ = f"{name}_builder"
    return Builder


T2ICCSBUBuilder = _make_builder("t2i_cc_sbu", T2XDataset, "IMAGE")
T2VWebVidBuilder = _make_builder("t2v_webvid", T2XDataset, "VIDEO")
T2AAudioCapBuilder = _make_builder("t2a_audiocap", T2XDataset, "AUDIO")
T2ITsCCSBUBuilder = _make_builder("t2i_ts_cc_sbu", T2XTsDataset, "IMAGE")
T2VTsWebVidBuilder = _make_builder("t2v_ts_webvid", T2XTsDataset, "VIDEO")
T2ATsAudioCapBuilder = _make_builder("t2a_ts_audiocap", T2XTsDataset, "AUDIO")
T2VTsMulWebVidBuilder = _make_builder("t2v_ts_mul_webvid", T2XTsDataset, "VIDEO")
T2VTsSpecWebVidBuilder = _make_builder("t2v_ts_spec_webvid", T2XTsSpecDataset,
                                       "VIDEO")
