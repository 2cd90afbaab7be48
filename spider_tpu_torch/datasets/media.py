"""Shard-byte media decoding (a copy of spider_tpu/datasets/media.py): mp4,
webm and avi video through OpenCV where it imports, wav through a stdlib RIFF
parser, flac through the pure-Python codec in ``datasets/flac.py``. Real
webvid and audiocap tar shards reach the clip pipelines
(``processors/{video,audio}.py``) through it.
"""

from __future__ import annotations

import os
import struct
import tempfile
from typing import Optional, Tuple

import numpy as np

from spider_tpu_torch.datasets.flac import decode_flac, sniff_audio

VIDEO_EXTS = ("mp4", "webm", "avi", "mkv", "mov", "m4v")
AUDIO_EXTS = ("flac", "wav")


def decode_video_bytes(data: bytes, max_frames: int = 64,
                       suffix: str = ".mp4") -> Optional[np.ndarray]:
    """Container bytes -> [T, H, W, 3] RGB uint8 (evenly strided to at most
    max_frames), or None if no frame decodes. cv2.VideoCapture needs a
    filesystem path, so the bytes round-trip through a temp file."""
    try:
        import cv2
    except ImportError:
        return None
    fd, path = tempfile.mkstemp(suffix=suffix)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            return None
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        keep_every = max(1, total // max_frames) if total > 0 else 1
        frames = []
        i = 0
        while len(frames) < max_frames:
            ok, frame = cap.read()
            if not ok:
                break
            if i % keep_every == 0:
                frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            i += 1
        cap.release()
        return np.stack(frames) if frames else None
    finally:
        os.unlink(path)


def decode_wav_bytes(data: bytes) -> Tuple[np.ndarray, int]:
    """RIFF/WAVE bytes -> (float32 waveform, sample_rate). Handles PCM
    8/16/24/32-bit and IEEE float32 (stdlib `wave` rejects the latter)."""
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a WAVE stream")
    pos = 12
    fmt = None
    pcm = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            pcm = body
        pos += 8 + size + (size & 1)
    if fmt is None or pcm is None:
        raise ValueError("missing fmt/data chunk")
    tag, channels, rate, _, _, bits = fmt
    if tag == 3 and bits == 32:
        wave = np.frombuffer(pcm, "<f4").astype(np.float32)
    elif tag in (1, 0xFFFE):
        if bits == 8:
            wave = (np.frombuffer(pcm, np.uint8).astype(np.float32) - 128) / 128
        elif bits == 16:
            wave = np.frombuffer(pcm, "<i2").astype(np.float32) / 32768
        elif bits == 24:
            raw = np.frombuffer(pcm, np.uint8).reshape(-1, 3)
            val = (raw[:, 0].astype(np.int32)
                   | (raw[:, 1].astype(np.int32) << 8)
                   | (raw[:, 2].astype(np.int32) << 16))
            val = np.where(val >= 1 << 23, val - (1 << 24), val)
            wave = val.astype(np.float32) / float(1 << 23)
        elif bits == 32:
            wave = np.frombuffer(pcm, "<i4").astype(np.float32) / (1 << 31)
        else:
            raise ValueError(f"unsupported wav bit depth {bits}")
    else:
        raise ValueError(f"unsupported wav format tag {tag}")
    if channels > 1:
        wave = wave.reshape(-1, channels)
    return wave, rate


def encode_wav_bytes(wave: np.ndarray, sample_rate: int = 16000) -> bytes:
    """float32 [-1,1] -> 16-bit PCM WAVE bytes (fixtures/tooling)."""
    wave = np.asarray(wave)
    channels = 1 if wave.ndim == 1 else wave.shape[1]
    pcm = np.clip(np.round(wave * 32767), -32768, 32767).astype("<i2")
    body = pcm.tobytes()
    hdr = (b"RIFF" + struct.pack("<I", 36 + len(body)) + b"WAVE"
           + b"fmt " + struct.pack("<IHHIIHH", 16, 1, channels, sample_rate,
                                   sample_rate * channels * 2,
                                   channels * 2, 16)
           + b"data" + struct.pack("<I", len(body)))
    return hdr + body


def decode_audio_bytes(data: bytes,
                       mono: bool = True) -> Optional[Tuple[np.ndarray, int]]:
    """flac/wav bytes -> (float32 waveform [n], sample_rate); None if the
    container is unrecognized. Multi-channel is mean-downmixed when mono."""
    kind = sniff_audio(data)
    try:
        if kind == "flac":
            wave, rate = decode_flac(data)
        elif kind == "wav":
            wave, rate = decode_wav_bytes(data)
        else:
            return None
    except (ValueError, IndexError, struct.error):
        return None
    if mono and wave.ndim > 1:
        wave = wave.mean(axis=-1)
    return wave.astype(np.float32), rate
