"""Audio preprocessing: waveform -> log-mel spectrogram clips, numpy-only
(a copy of spider_tpu/processors/audio.py)."""

from __future__ import annotations

import numpy as np


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def mel_filterbank(num_mels: int, n_fft: int, sample_rate: int,
                   fmin: float = 0.0, fmax: float = None) -> np.ndarray:
    fmax = fmax or sample_rate / 2
    mels = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), num_mels + 2)
    freqs = mel_to_hz(mels)
    bins = np.floor((n_fft + 1) * freqs / sample_rate).astype(int)
    fb = np.zeros((num_mels, n_fft // 2 + 1))
    for i in range(num_mels):
        l, c, r = bins[i], bins[i + 1], bins[i + 2]
        if c > l:
            fb[i, l:c] = (np.arange(l, c) - l) / (c - l)
        if r > c:
            fb[i, c:r] = (r - np.arange(c, r)) / (r - c)
    return fb.astype(np.float32)


def log_mel_spectrogram(waveform: np.ndarray, sample_rate: int = 16000,
                        num_mels: int = 128, n_fft: int = 400,
                        hop_length: int = 160,
                        target_length: int = 204) -> np.ndarray:
    """waveform [T] -> [1, num_mels, target_length] log-mel (fbank-style)."""
    w = np.asarray(waveform, np.float32)
    if w.ndim > 1:
        w = w.mean(axis=0)
    pad = n_fft // 2
    w = np.pad(w, (pad, pad), mode="reflect") if len(w) > pad else np.pad(
        w, (pad, pad))
    num_frames = max(1, 1 + (len(w) - n_fft) // hop_length)
    idx = np.arange(n_fft)[None, :] + hop_length * np.arange(num_frames)[:, None]
    frames = w[idx] * np.hanning(n_fft)[None, :]
    spec = np.abs(np.fft.rfft(frames, n=n_fft, axis=-1)) ** 2  # [F, n_fft/2+1]
    fb = mel_filterbank(num_mels, n_fft, sample_rate)
    mel = spec @ fb.T                                           # [F, M]
    logmel = np.log(mel + 1e-10).T.astype(np.float32)           # [M, F]
    # pad/crop time axis to target_length
    M, F = logmel.shape
    if F < target_length:
        logmel = np.pad(logmel, ((0, 0), (0, target_length - F)))
    else:
        logmel = logmel[:, :target_length]
    # per-clip normalization (ImageBind convention: mean -4.268, std 9.138)
    logmel = (logmel + 4.268) / (9.138 * 2)
    return logmel[None]


def audio_to_clips(waveform: np.ndarray, sample_rate: int = 16000,
                   num_clips: int = 3, clip_seconds: float = 2.0,
                   **mel_kwargs) -> np.ndarray:
    """waveform -> [num_clips, 1, M, T] evenly spaced mel clips."""
    w = np.asarray(waveform, np.float32).reshape(-1)
    clip_len = int(clip_seconds * sample_rate)
    if len(w) < clip_len:
        w = np.pad(w, (0, clip_len - len(w)))
    starts = np.linspace(0, max(len(w) - clip_len, 0), num_clips).astype(int)
    clips = [log_mel_spectrogram(w[s: s + clip_len], sample_rate, **mel_kwargs)
             for s in starts]
    return np.stack(clips, axis=0)
