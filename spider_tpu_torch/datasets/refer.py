"""REFER corpus loader for the real refs(unc).p / instances.json format (a
copy of spider_tpu/datasets/refer.py, which is numpy and Python only).

The loading, indexing and mask path of the REFER API without
pycocotools/skimage/matplotlib: polygons rasterize through cv2.fillPoly (or a
numpy scanline fallback) and COCO RLE, both uncompressed counts lists and
the compressed LEB128 string form, decodes in numpy.

Layout (data_root/refcoco/):
  refs(unc).p      pickled list of refs: {ref_id, ann_id, image_id,
                   sentences: [{sent, raw, ...}], split, ...}
  instances.json   COCO instances: images / annotations (bbox xywh,
                   segmentation) / categories
Images live under vis_root (COCO train2014 file names).
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Any, Dict, Iterator, List, Optional

import numpy as np


def decode_compressed_rle(counts: str, h: int, w: int) -> np.ndarray:
    """COCO compressed RLE string -> [h, w] uint8 mask (column-major runs)."""
    # LEB128-style varint with 6-bit groups, sign-extended, delta-coded
    # from the run before last (pycocotools rleFrString).
    vals: List[int] = []
    pos = 0
    while pos < len(counts):
        x, k, more = 0, 0, 1
        while more:
            c = ord(counts[pos]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = c & 0x20
            pos += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k + 5)
            k += 1
        if len(vals) > 2:
            x += vals[-2]
        vals.append(x)
    return _runs_to_mask(vals, h, w)


def _runs_to_mask(runs: List[int], h: int, w: int) -> np.ndarray:
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for run in runs:
        if val:
            flat[pos:pos + run] = 1
        pos += run
        val ^= 1
    return flat.reshape(w, h).T  # COCO RLE is column-major


def polygons_to_mask(polys: List[List[float]], h: int, w: int) -> np.ndarray:
    """COCO polygon list [[x0,y0,x1,y1,...], ...] -> [h, w] uint8 mask."""
    try:
        import cv2

        mask = np.zeros((h, w), np.uint8)
        pts = [np.asarray(p, np.float64).reshape(-1, 2).round().astype(np.int32)
               for p in polys if len(p) >= 6]
        if pts:
            cv2.fillPoly(mask, pts, 1)
        return mask
    except ImportError:
        return _scanline_fill(polys, h, w)


def _scanline_fill(polys: List[List[float]], h: int, w: int) -> np.ndarray:
    mask = np.zeros((h, w), np.uint8)
    for p in polys:
        xy = np.asarray(p, np.float64).reshape(-1, 2)
        if len(xy) < 3:
            continue
        x, y = xy[:, 0], xy[:, 1]
        xn, yn = np.roll(x, -1), np.roll(y, -1)
        for row in range(h):
            yc = row + 0.5
            crosses = (y <= yc) != (yn <= yc)
            if not crosses.any():
                continue
            xs = x[crosses] + (yc - y[crosses]) / (yn[crosses] - y[crosses]) \
                * (xn[crosses] - x[crosses])
            xs = np.sort(xs)
            for i in range(0, len(xs) - 1, 2):
                a, b = int(np.ceil(xs[i] - 0.5)), int(np.floor(xs[i + 1] - 0.5))
                mask[row, max(a, 0): min(b, w - 1) + 1] = 1
    return mask


def ann_to_mask(ann: Dict[str, Any], h: int, w: int) -> np.ndarray:
    seg = ann.get("segmentation")
    if seg is None:
        return np.zeros((h, w), np.uint8)
    if isinstance(seg, list):
        return polygons_to_mask(seg, h, w)
    counts = seg["counts"]
    sh, sw = seg.get("size", (h, w))
    if isinstance(counts, str):
        return decode_compressed_rle(counts, sh, sw)
    return _runs_to_mask(list(counts), sh, sw)


class ReferCorpus:
    """REFER(data_root, vis_root, dataset, splitBy) equivalent: indexes refs
    against COCO instances and yields grounding records."""

    def __init__(self, data_root: str, vis_root: str = "",
                 dataset: str = "refcoco", split_by: str = "unc"):
        dataset = dataset.split("inv")[-1]  # invrefcoco shares storage
        ann_dir = os.path.join(data_root, dataset)
        with open(os.path.join(ann_dir, f"refs({split_by}).p"), "rb") as f:
            self.refs: List[Dict] = pickle.load(f)
        with open(os.path.join(ann_dir, "instances.json")) as f:
            inst = json.load(f)
        self.vis_root = vis_root
        self.imgs = {im["id"]: im for im in inst["images"]}
        self.anns = {a["id"]: a for a in inst["annotations"]}
        self.cats = {c["id"]: c["name"] for c in inst.get("categories", [])}

    def ref_ids(self, split: Optional[str] = None) -> List[int]:
        return [r["ref_id"] for r in self.refs
                if split is None or r.get("split") == split]

    def load_ref(self, ref_id: int) -> Dict:
        for r in self.refs:
            if r["ref_id"] == ref_id:
                return r
        raise KeyError(ref_id)

    def get_mask(self, ref: Dict) -> np.ndarray:
        ann = self.anns[ref["ann_id"]]
        img = self.imgs[ref["image_id"]]
        return ann_to_mask(ann, img["height"], img["width"])

    def _load_image(self, img: Dict) -> np.ndarray:
        path = os.path.join(self.vis_root, img.get("file_name", ""))
        if self.vis_root and os.path.exists(path):
            from PIL import Image

            return np.asarray(Image.open(path).convert("RGB"))
        # image files absent (annotation-only mount): neutral canvas keeps
        # the pipeline runnable; real training mounts COCO train2014
        return np.zeros((img["height"], img["width"], 3), np.uint8)

    def records(self, split: Optional[str] = "train") -> Iterator[Dict]:
        """Yields {image, caption, box xywh, mask} — the grounding builder's
        record schema (one record per ref×sentence, like it2m_ts_refcoco)."""
        for ref in self.refs:
            if split is not None and ref.get("split") != split:
                continue
            ann = self.anns[ref["ann_id"]]
            img = self.imgs[ref["image_id"]]
            image = self._load_image(img)
            mask = ann_to_mask(ann, img["height"], img["width"])
            for sent in ref["sentences"]:
                yield dict(image=image,
                           caption=sent.get("sent") or sent.get("raw", ""),
                           box=np.asarray(ann["bbox"], np.float32),
                           mask=mask)


class ReferRecordSource:
    """Materialized, indexable view over ReferCorpus.records(split) — the
    map-style source the grounding builder wraps (images lazy-loaded)."""

    def __init__(self, corpus: ReferCorpus, split: str = "train",
                 limit: Optional[int] = None):
        self.corpus = corpus
        self.index: List[tuple] = []
        for ref in corpus.refs:
            if split is not None and ref.get("split") != split:
                continue
            for s, _ in enumerate(ref["sentences"]):
                self.index.append((ref["ref_id"], s))
            if limit and len(self.index) >= limit:
                break

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, i: int) -> Dict:
        ref_id, s = self.index[i]
        ref = self.corpus.load_ref(ref_id)
        ann = self.corpus.anns[ref["ann_id"]]
        img = self.corpus.imgs[ref["image_id"]]
        return dict(image=self.corpus._load_image(img),
                    caption=ref["sentences"][s].get("sent", ""),
                    box=np.asarray(ann["bbox"], np.float32),
                    mask=ann_to_mask(ann, img["height"], img["width"]))
