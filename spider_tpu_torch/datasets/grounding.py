"""Grounding builders (a copy of spider_tpu/datasets/grounding.py): referring
detection (BOX) and segmentation (MASK) on RefCOCO-style data.

Sources, in the order they are tried: a REFER corpus (``refer_root``:
refs(unc).p + instances.json, images under ``image_path``), a RefCOCO-style
annotation JSON (``ann_path``: a list of {image, bbox xywh, sentences}) with
its image dir, else the synthetic twin, which draws a colored rectangle and
its mask."""

from __future__ import annotations

import json
import os
import random
from typing import Dict, Optional

import numpy as np

from spider_tpu_torch.common.registry import registry
from spider_tpu_torch.datasets import backends
from spider_tpu_torch.datasets.base import BaseBuilder, MapSampleDataset, pick
from spider_tpu_torch.processors.text import text_processor
from spider_tpu_torch.processors.vision import (clip_image_transform,
                                                image_to_imagebind, resize_pad,
                                                sam_preprocess)

BOX_POOL = [
    "{}",
    "Detect {}",
    "give me the bounding box of {}",
    "give me the location of {}",
    "where is {}",
    "from this image, tell me the location of {}",
    "the location of {} is",
    "could you tell me the location for {}",
    "where can I locate the {}",
]

MASK_POOL = [
    "{}",
    "Segment {}",
    "give me the mask of {}",
    "segment the region of {}",
    "where exactly is {}",
    "please segment {}",
    "could you segment {} in this image",
]


def _scale_box_xyxy(box_xywh: np.ndarray, src_hw, dst: int) -> np.ndarray:
    """xywh in the original image -> xyxy in the resize-pad dst frame."""
    h, w = src_hw
    scale = dst / max(h, w)
    x, y, bw, bh = box_xywh
    return np.array([x * scale, y * scale, (x + bw) * scale, (y + bh) * scale],
                    np.float32)


class ReferDataset(MapSampleDataset):
    """mode: 'box' | 'mask'; ts=True switches TaskPrompt to SMARTMULTIMODAL."""

    def __init__(self, mode: str, build_info: Dict, ts: bool = False,
                 seed: int = 0):
        self.mode = mode
        self.ts = ts
        self.build_info = build_info
        self.rng = random.Random(seed)
        if build_info.get("refer_root") and \
                os.path.isdir(build_info["refer_root"]):
            # real REFER pickle corpus (refs(unc).p + instances.json)
            from spider_tpu_torch.datasets.refer import (ReferCorpus,
                                                         ReferRecordSource)

            corpus = ReferCorpus(build_info["refer_root"],
                                 build_info.get("image_path", ""),
                                 dataset=build_info.get("dataset", "refcoco"),
                                 split_by=build_info.get("split_by", "unc"))
            source = ReferRecordSource(corpus,
                                       split=build_info.get("split", "train"),
                                       limit=build_info.get("num_samples"))
        elif build_info.get("ann_path") and os.path.exists(build_info["ann_path"]):
            with open(build_info["ann_path"]) as f:
                anns = json.load(f)
            source = _RealRefer(anns, build_info.get("image_path", ""))
        else:
            source = backends.SyntheticGrounding(
                size=build_info.get("synthetic_size", 96), seed=seed,
                length=build_info.get("num_samples", 64))
        super().__init__(source, self._to_dict)

    def _to_dict(self, index: int, rec: Dict) -> Dict:
        image = rec["image"]
        caption = text_processor(rec["caption"])
        box = np.asarray(rec["box"], np.float32)        # xywh original
        oh, ow = image.shape[:2]

        image_aug = clip_image_transform(image, 224)
        image_ib = image_to_imagebind(image, 224)
        sam_size = self.build_info.get("sam_size", 1024)
        image_sam, sam_hw = sam_preprocess(image, sam_size)
        box_512 = _scale_box_xyxy(box, (oh, ow), 512)

        meta = {
            "original_shape": [(oh, ow)],
            "aug_shape": [(224, 224)],
            "sam_shape": [sam_hw],
            "original_box": [np.array([box[0], box[1], box[0] + box[2],
                                       box[1] + box[3]], np.float32)],
            "aug_box": [box_512],
        }

        if self.mode == "box":
            pool, m, task = BOX_POOL, "BOX", "[BOX]"
            payload = {"BOX": box_512}
        else:
            pool, m, task = MASK_POOL, "MASK", "[MASK]"
            mask = rec.get("mask")
            if mask is None:
                mask = np.zeros((oh, ow), np.uint8)
            mask_sam = resize_pad(mask[..., None].astype(np.float32),
                                  sam_size)[..., 0]
            payload = {"MASK": (mask_sam > 0.5).astype(np.float32),
                       "BOX": box_512}

        instruction = pick(self.rng, pool).format(caption)
        question = f"<IMAGE><IMAGE-Placeholder></IMAGE> {instruction} "
        answer = f"<{m}>{caption}<{m}-Placeholder></{m}>"
        task_prompt = "[SMARTMULTIMODAL]" if self.ts else task
        return {
            "Question": question,
            "TaskPrompt": task_prompt,
            "Answer": answer,
            "IMAGE": image_ib,
            "IMAGE_AUG": image_aug,
            "IMAGE_SAM": image_sam,
            "Image_ori_array": image,
            "Meta_info": meta,
            "Caption": caption,
            **payload,
        }


class _RealRefer:
    def __init__(self, anns, image_dir):
        self.anns = anns
        self.image_dir = image_dir

    def __len__(self):
        return len(self.anns)

    def __getitem__(self, i):
        from PIL import Image

        a = self.anns[i]
        img = np.asarray(
            Image.open(os.path.join(self.image_dir, a["image"])).convert("RGB"))
        sent = a["sentences"]
        caption = sent[np.random.randint(len(sent))] if isinstance(sent, list) \
            else sent
        out = dict(image=img, caption=caption,
                   box=np.asarray(a["bbox"], np.float32))
        if "mask" in a:
            out["mask"] = np.asarray(a["mask"], np.uint8)
        return out


def _make_builder(name: str, mode: str, ts: bool):
    @registry.register_builder(name)
    class Builder(BaseBuilder):
        def build_datasets(self):
            return ReferDataset(mode, self.build_info, ts=ts,
                                seed=self.build_info.get("seed", 0))

    Builder.__name__ = f"{name}_builder"
    return Builder


IT2BRefCOCOBuilder = _make_builder("it2b_refcoco", "box", ts=False)
IT2MRefCOCOBuilder = _make_builder("it2m_refcoco", "mask", ts=False)
IT2BTsRefCOCOBuilder = _make_builder("it2b_ts_refcoco", "box", ts=True)
IT2MTsRefCOCOBuilder = _make_builder("it2m_ts_refcoco", "mask", ts=True)
