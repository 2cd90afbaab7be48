"""Data sources (a copy of spider_tpu/datasets/backends.py, which is numpy and
Python only). Webdataset tar shards, COCO/REFER annotations, HDF5 story files
and JSON travel files; every source also has a synthetic twin so the full pipeline
runs without files. Real media decode through ``datasets/media.py``; tar shards
are walked by the native reader (``datasets/native_loader.py``) where it builds.
"""

from __future__ import annotations

import glob
import io
import json
import os
import random
import tarfile
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np


def _decode_member(name: str, data: bytes):
    """Shard member bytes -> usable value (the wds `decode` stage). Video
    members become [T,H,W,3] uint8 frame arrays, audio members become
    (waveform float32, sample_rate)."""
    from spider_tpu_torch.datasets import media

    ext = name.rsplit(".", 1)[-1].lower()
    if ext in ("jpg", "jpeg", "png", "webp"):
        try:
            from PIL import Image

            return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        except Exception:
            return None
    if ext in ("txt", "text", "caption"):
        return data.decode("utf-8", errors="replace").strip()
    if ext == "json":
        return json.loads(data)
    if ext in ("npy",):
        return np.load(io.BytesIO(data))
    if ext in media.VIDEO_EXTS:
        return media.decode_video_bytes(data, suffix=f".{ext}")
    if ext in media.AUDIO_EXTS:
        return media.decode_audio_bytes(data)
    return data  # raw bytes, decoded downstream if at all


def _store_member(sample: Dict[str, Any], key: str, ext: str, decoded) -> None:
    """Normalize a decoded member into the sample dict: audio tuples carry
    their rate, pre-decoded '<container>.npy' members (tools/
    reshard_predecoded.py) expose the original field name."""
    if isinstance(decoded, tuple):  # audio: (wave, rate)
        decoded, sample["sample_rate"] = decoded
    field = ext.lower()
    if field.endswith(".npy"):
        field = field[:-4]
    if field == "sample_rate":
        if isinstance(decoded, (bytes, bytearray)):
            decoded = decoded.decode()
        sample["sample_rate"] = int(float(decoded))
        return
    sample[field] = decoded
    sample["__key__"] = key


class TarShardSource:
    """webdataset-style reader: tar shards of `key.ext` members grouped by
    key. Resampled (infinite) iteration with a shuffle buffer — the
    ResampledShards -> tarfile_to_samples -> shuffle(1000) pipeline without
    the webdataset dependency."""

    # members always decoded regardless of decode_exts (cheap metadata)
    _META_EXTS = ("txt", "text", "caption", "json", "npy", "sample_rate")

    def __init__(self, pattern: str, shuffle_buffer: int = 1000,
                 seed: int = 0, resample: bool = True,
                 native: str = "auto",
                 decode_exts: Optional[Sequence[str]] = None):
        self.shards = sorted(glob.glob(pattern)) if isinstance(pattern, str) \
            else list(pattern)
        if not self.shards:
            raise FileNotFoundError(f"no shards match {pattern}")
        self.shuffle_buffer = shuffle_buffer
        self.seed = seed
        self.resample = resample
        # decode_exts: when set, only members with these extensions (plus
        # cheap metadata members) are decoded — a video builder must not pay
        # a full FLAC decode per sample for audio members it never reads
        # (measured: 0.13 s/member through the pure-Python decoder, which
        # multiplied by the shuffle buffer dominated the ingest wall).
        self.decode_exts = None if decode_exts is None else {
            e.lower().lstrip(".") for e in decode_exts}
        # native='auto': the C++ threaded reader (native/tarreader.cpp) runs
        # the tar walk + byte prefetch off the GIL when its .so builds;
        # 'never' forces pure Python (and SPIDER_NATIVE_TAR=0 disables
        # globally). Shuffle-buffer/decode semantics are identical — only
        # the shard-interleave order differs (native threads interleave).
        self.native = native
        if os.environ.get("SPIDER_NATIVE_TAR", "1") == "0":
            self.native = "never"
        self.reader: Optional[str] = None

    def _wanted(self, ext: str) -> bool:
        if self.decode_exts is None:
            return True
        parts = ext.lower().split(".")
        return any(p in self.decode_exts or p in self._META_EXTS
                   for p in parts)

    def _native_reader(self, shards: List[str]):
        """Best-effort native byte source; None if the .so can't build
        (NativeTarSource loads its library when it is made)."""
        if self.native == "never":
            return None
        try:
            from spider_tpu_torch.datasets.native_loader import NativeTarSource

            return NativeTarSource(shards, decode=False)
        except Exception:
            if self.native == "always":
                raise
            return None

    def _iter_all_shards(self, shards: List[str]) -> Iterator[Dict[str, Any]]:
        native = self._native_reader(shards)
        # which reader walked the shards last: "native" or "python"
        self.reader = "python" if native is None else "native"
        if native is not None:
            for raw in native:
                sample: Dict[str, Any] = {}
                key = raw.pop("__key__", "")
                for ext, data in raw.items():
                    if not self._wanted(ext):
                        continue
                    decoded = _decode_member(f"{key}.{ext}", data)
                    if decoded is not None:
                        _store_member(sample, key, ext, decoded)
                if sample:
                    yield sample
            return
        for shard in shards:
            try:
                yield from self._iter_shard(shard)
            except (tarfile.TarError, OSError):
                continue  # warn_and_continue semantics

    def _iter_shard(self, path: str) -> Iterator[Dict[str, Any]]:
        with tarfile.open(path) as tf:
            current_key = None
            sample: Dict[str, Any] = {}
            for member in tf:
                if not member.isfile():
                    continue
                base = os.path.basename(member.name)
                key, _, ext = base.partition(".")
                if current_key is not None and key != current_key and sample:
                    yield sample
                    sample = {}
                current_key = key
                if not self._wanted(ext):
                    continue
                data = tf.extractfile(member).read()
                decoded = _decode_member(base, data)
                if decoded is not None:
                    _store_member(sample, key, ext, decoded)
            if sample:
                yield sample

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        rng = random.Random(self.seed)
        buffer: List[Dict[str, Any]] = []
        epoch = 0
        while True:
            shards = list(self.shards)
            rng.shuffle(shards)
            for sample in self._iter_all_shards(shards):
                buffer.append(sample)
                if len(buffer) >= self.shuffle_buffer:
                    idx = rng.randrange(len(buffer))
                    buffer[idx], buffer[-1] = buffer[-1], buffer[idx]
                    yield buffer.pop()
            epoch += 1
            if not self.resample:
                break
        rng.shuffle(buffer)
        yield from buffer


class SyntheticImageText:
    """Infinite (image uint8 HWC, caption) pairs for hermetic pipelines."""

    CAPTIONS = [
        "a dog running on grass", "a red apple on a table",
        "a city skyline at night", "two cats sleeping", "a mountain lake",
        "an airplane in a blue sky", "a bowl of noodles", "a child drawing",
    ]

    def __init__(self, size: int = 64, seed: int = 0, length: int = 1 << 30):
        self.size = size
        self.seed = seed
        self.length = length

    def __len__(self):
        return self.length

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        while True:
            img = rng.integers(0, 256, (self.size, self.size, 3), np.uint8)
            yield {"jpg": img,
                   "txt": self.CAPTIONS[int(rng.integers(len(self.CAPTIONS)))]}


class SyntheticVideoText(SyntheticImageText):
    def __init__(self, size: int = 64, frames: int = 8, **kw):
        super().__init__(size=size, **kw)
        self.frames = frames

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        while True:
            vid = rng.integers(0, 256,
                               (self.frames, self.size, self.size, 3), np.uint8)
            yield {"mp4": vid,
                   "txt": self.CAPTIONS[int(rng.integers(len(self.CAPTIONS)))]}


class SyntheticAudioText(SyntheticImageText):
    def __init__(self, seconds: float = 2.0, sample_rate: int = 16000, **kw):
        super().__init__(**kw)
        self.samples = int(seconds * sample_rate)
        self.sample_rate = sample_rate

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        while True:
            wav = rng.normal(0, 0.1, (self.samples,)).astype(np.float32)
            yield {"flac": wav, "sample_rate": self.sample_rate,
                   "txt": self.CAPTIONS[int(rng.integers(len(self.CAPTIONS)))]}


class SyntheticGrounding:
    """(image, caption, box xywh) triples with the box drawn in the image."""

    def __init__(self, size: int = 96, seed: int = 0, length: int = 1 << 30):
        self.size = size
        self.seed = seed
        self.length = length

    def __len__(self):
        return self.length

    def __getitem__(self, index: int):
        rng = np.random.default_rng(self.seed + index)
        img = rng.integers(0, 256, (self.size, self.size, 3), np.uint8)
        x, y = rng.integers(0, self.size // 2, 2)
        w, h = rng.integers(8, self.size // 2, 2)
        img[y: y + h, x: x + w] = rng.integers(0, 256, 3, np.uint8)
        name = SyntheticImageText.CAPTIONS[
            int(rng.integers(len(SyntheticImageText.CAPTIONS)))]
        mask = np.zeros((self.size, self.size), np.uint8)
        mask[y: y + h, x: x + w] = 1
        return dict(image=img, caption=name,
                    box=np.array([x, y, w, h], np.float32), mask=mask)


class SyntheticStory:
    """HDF5-story stand-in: 5-frame image sequences + per-frame texts
    (pororo/flintstones schema)."""

    def __init__(self, size: int = 64, num_frames: int = 5, seed: int = 0,
                 length: int = 64):
        self.size = size
        self.num_frames = num_frames
        self.seed = seed
        self.length = length

    def __len__(self):
        return self.length

    def __getitem__(self, index: int):
        rng = np.random.default_rng(self.seed + index)
        frames = rng.integers(
            0, 256, (self.num_frames, self.size, self.size, 3), np.uint8)
        texts = [f"frame {i} of story {index}" for i in range(self.num_frames)]
        return dict(images=frames, texts=texts)


class Hdf5Story:
    """Real pororo/flintstones HDF5 reader (gated on h5py)."""

    def __init__(self, path: str, image_key: str = "image",
                 text_key: str = "text"):
        import h5py  # noqa: F401 — raises if unavailable

        self.path = path
        self.image_key = image_key
        self.text_key = text_key
        self._h5 = None

    def _file(self):
        import h5py

        if self._h5 is None:
            self._h5 = h5py.File(self.path, "r")
        return self._h5

    def __len__(self):
        return len(self._file()[self.image_key])

    def __getitem__(self, index: int):
        f = self._file()
        images = np.asarray(f[self.image_key][index])
        texts = [t.decode() if isinstance(t, bytes) else str(t)
                 for t in f[self.text_key][index]]
        return dict(images=images, texts=texts)
