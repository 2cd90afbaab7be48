"""Attention-map overlay visualization (a copy of
spider_tpu/common/gradcam.py, numpy only)."""

from __future__ import annotations

import numpy as np


def _gaussian_blur(x: np.ndarray, sigma: float) -> np.ndarray:
    if sigma <= 0:
        return x
    radius = max(1, int(3 * sigma))
    t = np.arange(-radius, radius + 1)
    k = np.exp(-(t ** 2) / (2 * sigma ** 2))
    k /= k.sum()
    for axis in (0, 1):
        x = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), axis, x)
    return x


def normalize(x: np.ndarray) -> np.ndarray:
    x = x - x.min()
    return x / (x.max() + 1e-8)


def get_att_map(img: np.ndarray, att_map: np.ndarray, blur: bool = True,
                overlap: bool = True) -> np.ndarray:
    """img [H,W,3] float in [0,1]; att_map [h,w] -> overlay [H,W,3]."""
    from spider_tpu_torch.processors.vision import _bilinear_resize

    H, W = img.shape[:2]
    att = _bilinear_resize(att_map[..., None].astype(np.float32), H, W)[..., 0]
    if blur:
        att = _gaussian_blur(att, 0.02 * max(H, W))
    att = normalize(att)
    # simple jet-like colormap
    cmap = np.stack([
        np.clip(1.5 - np.abs(4 * att - 3), 0, 1),
        np.clip(1.5 - np.abs(4 * att - 2), 0, 1),
        np.clip(1.5 - np.abs(4 * att - 1), 0, 1),
    ], axis=-1)
    if overlap:
        return (1 - att[..., None] ** 0.7) * img + att[..., None] ** 0.7 * cmap
    return cmap
