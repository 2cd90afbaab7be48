"""The port's media decoding (``datasets/flac.py``, ``datasets/media.py``)
against the JAX package on the CPU: FLAC streams byte-equal to the JAX
encoder's and decoded exactly (every 16-bit sample back, for each subframe
type, stereo and multi-frame streams), wav, the container sniff, and mp4
video through cv2 where it imports (without cv2 a video decodes to None, as
in the JAX package)."""

import os
import struct
import sys
import tempfile

import numpy as np
import pytest

from spider_tpu.datasets import flac as jflac
from spider_tpu.datasets import media as jmedia
from spider_tpu_torch.datasets import flac, media


def _tone(seconds=1.0, rate=8000, freq=440.0, channels=1):
    t = np.arange(int(seconds * rate)) / rate
    wave = 0.5 * np.sin(2 * np.pi * freq * t).astype(np.float32)
    if channels == 2:
        wave = np.stack([wave, 0.25 * wave], axis=1)
    return wave


def _pcm16(wave):
    return np.clip(np.round(np.asarray(wave) * 32768), -32768, 32767)


@pytest.mark.parametrize("subframe", ["verbatim", "fixed2", "lpc2"])
@pytest.mark.parametrize("channels,seconds", [(1, 1.0), (2, 2.0)])
def test_flac_bytes_equal_the_jax_encoder_and_decode_exactly(subframe, channels, seconds):
    wave = _tone(seconds=seconds, channels=channels)     # 2 s: 16000 samples, 4 frames
    data = flac.encode_flac(wave, sample_rate=8000, subframe=subframe)
    assert data == jflac.encode_flac(wave, sample_rate=8000, subframe=subframe)
    out, rate = flac.decode_flac(data)
    jout, _ = jflac.decode_flac(data)
    assert rate == 8000 and out.shape == wave.shape and out.dtype == jout.dtype
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(out * 32768, _pcm16(wave))


def test_flac_odd_lengths_and_a_short_last_frame():
    wave = np.random.default_rng(0).uniform(-0.9, 0.9, 4096 + 3).astype(np.float32)
    data = flac.encode_flac(wave, sample_rate=16000)       # last frame: 3 samples, verbatim
    assert data == jflac.encode_flac(wave, sample_rate=16000)
    out, rate = flac.decode_flac(data)
    assert rate == 16000
    np.testing.assert_array_equal(out * 32768, _pcm16(wave))


def test_bit_reader_writer_and_crcs_equal_the_jax_copies():
    rng = np.random.default_rng(1)
    w, jw = flac.BitWriter(), jflac.BitWriter()
    fields = [(int(rng.integers(0, 1 << n)), int(n)) for n in rng.integers(1, 33, 50)]
    for v, n in fields:
        w.write(v, n)
        jw.write(v, n)
    w.align()
    jw.align()
    assert w.bytes() == jw.bytes()
    r = flac.BitReader(w.bytes())
    assert [r.read(n) for _, n in fields] == [v for v, _ in fields]
    blob = bytes(rng.integers(0, 256, 300, np.uint8))
    assert flac._crc8(blob) == jflac._crc8(blob) and flac._crc16(blob) == jflac._crc16(blob)


def test_wav_roundtrip_and_bit_depths():
    wave = _tone()
    blob = media.encode_wav_bytes(wave, 8000)
    assert blob == jmedia.encode_wav_bytes(wave, 8000)
    out, rate = media.decode_wav_bytes(blob)
    assert rate == 8000
    np.testing.assert_array_equal(out, jmedia.decode_wav_bytes(blob)[0])
    assert np.max(np.abs(out - wave)) < 2.0 / 32768
    stereo = _tone(channels=2)
    out, _ = media.decode_wav_bytes(media.encode_wav_bytes(stereo, 8000))
    assert out.shape == stereo.shape
    # 8-bit, 24-bit and float32 PCM through the same chunk walk
    for tag, bits, pcm in ((1, 8, (np.arange(10) * 20).astype(np.uint8).tobytes()),
                           (1, 24, bytes(range(30))),
                           (3, 32, np.linspace(-1, 1, 10).astype("<f4").tobytes())):
        fmt = struct.pack("<IHHIIHH", 16, tag, 1, 8000, 8000 * bits // 8, bits // 8, bits)
        blob = (b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE" + b"fmt " + fmt
                + b"data" + struct.pack("<I", len(pcm)) + pcm)
        got, want = media.decode_wav_bytes(blob), jmedia.decode_wav_bytes(blob)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1] == 8000
    with pytest.raises(ValueError):
        media.decode_wav_bytes(b"RIFF\0\0\0\0WAVE")


def test_audio_sniff_dispatch():
    wave = _tone(channels=2)
    for blob in (flac.encode_flac(wave, 8000), media.encode_wav_bytes(wave, 8000)):
        out, rate = media.decode_audio_bytes(blob)
        jout, _ = jmedia.decode_audio_bytes(blob)
        assert rate == 8000 and out.ndim == 1 and out.dtype == np.float32
        np.testing.assert_array_equal(out, jout)
        assert media.decode_audio_bytes(blob, mono=False)[0].shape == wave.shape
    assert flac.sniff_audio(b"fLaC....") == "flac" and flac.sniff_audio(b"OggS") is None
    assert media.decode_audio_bytes(b"garbage-not-audio") is None
    assert media.decode_audio_bytes(b"fLaC" + b"\0" * 10) is None     # truncated


def _tiny_mp4(frames=12, size=48):
    cv2 = pytest.importorskip("cv2")
    fd, path = tempfile.mkstemp(suffix=".mp4")
    os.close(fd)
    try:
        w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 8, (size, size))
        if not w.isOpened():
            pytest.skip("this cv2 build cannot encode mp4")
        for i in range(frames):
            w.write(np.full((size, size, 3), (i * 17) % 255, np.uint8))
        w.release()
        with open(path, "rb") as f:
            return f.read()
    finally:
        os.unlink(path)


def test_video_bytes_decode_as_the_jax_copy():
    data = _tiny_mp4()
    frames = media.decode_video_bytes(data)
    assert frames is not None and frames.ndim == 4 and frames.shape[-1] == 3
    assert len(frames) >= 8
    np.testing.assert_array_equal(frames, jmedia.decode_video_bytes(data))
    np.testing.assert_array_equal(media.decode_video_bytes(data, max_frames=4),
                                  jmedia.decode_video_bytes(data, max_frames=4))
    assert media.decode_video_bytes(b"not a video") is None


def test_video_decodes_to_none_without_cv2(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)        # import cv2 raises ImportError
    assert media.decode_video_bytes(b"\0" * 64) is None
