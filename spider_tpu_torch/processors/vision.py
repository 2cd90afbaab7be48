"""Vision preprocessing in pure numpy (a copy of
spider_tpu/processors/vision.py): resize-pad to 224/512/1024, CLIP
normalization, SAM normalization + pad-to-1024, DETR normalization.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
SAM_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
SAM_STD = np.array([58.395, 57.12, 57.375], np.float32)


def _bilinear_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """HWC uint8/float -> HWC float32, bilinear (no external deps)."""
    h, w = img.shape[:2]
    img = img.astype(np.float32)
    if (h, w) == (out_h, out_w):
        return img
    ys = (np.arange(out_h) + 0.5) * h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * w / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    a = img[y0][:, x0]
    b = img[y0][:, x1]
    c = img[y1][:, x0]
    d = img[y1][:, x1]
    return (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
            + c * wy * (1 - wx) + d * wy * wx)


def resize_longest_side(img: np.ndarray, target: int) -> np.ndarray:
    """SAM's ResizeLongestSide."""
    h, w = img.shape[:2]
    scale = target / max(h, w)
    return _bilinear_resize(img, int(round(h * scale)), int(round(w * scale)))


def resize_pad(img: np.ndarray, size: int) -> np.ndarray:
    """Resize longest side to `size` then zero-pad to square (the imgaug
    Resize+PadToFixedSize pipeline)."""
    img = resize_longest_side(img, size)
    h, w = img.shape[:2]
    out = np.zeros((size, size, img.shape[2]), np.float32)
    out[:h, :w] = img
    return out


def clip_image_transform(img: np.ndarray, size: int = 224) -> np.ndarray:
    """uint8 HWC -> normalized CHW float32 (vision_tensor_transform)."""
    x = resize_pad(img, size) / 255.0
    x = (x - CLIP_MEAN) / CLIP_STD
    return x.transpose(2, 0, 1)


def torch_transform(img, size: int = 224) -> np.ndarray:
    """PIL/array -> random-crop-free resize + CLIP norm CHW
    (vision_processor.torch_transform equivalent, deterministic)."""
    arr = np.asarray(img)
    return clip_image_transform(arr, size)


def sam_preprocess(img: np.ndarray, size: int = 1024
                   ) -> Tuple[np.ndarray, Tuple[int, int]]:
    """uint8 HWC -> SAM-normalized CHW padded to size x size; returns the
    pre-pad (h, w) as sam_shape (vision_processor.sam_preprocess)."""
    resized = resize_longest_side(img, size)
    h, w = resized.shape[:2]
    x = (resized - SAM_MEAN) / SAM_STD
    out = np.zeros((size, size, 3), np.float32)
    out[:h, :w] = x
    return out.transpose(2, 0, 1), (h, w)


def detr_preprocess(img_chw: np.ndarray) -> np.ndarray:
    """ImageNet-normalize a CHW float image in [0,255]."""
    mean = np.array([123.675, 116.28, 103.53], np.float32).reshape(3, 1, 1)
    std = np.array([58.395, 57.12, 57.375], np.float32).reshape(3, 1, 1)
    return (img_chw.astype(np.float32) - mean) / std


def image_to_imagebind(img: np.ndarray, size: int = 224,
                       frames: int = 2) -> np.ndarray:
    """uint8 HWC -> [3, frames, size, size] 2-frame tube for the vision
    trunk (images are repeated over the tube axis)."""
    chw = clip_image_transform(img, size)
    return np.repeat(chw[:, None], frames, axis=1)


def train_augment(img: np.ndarray, rng: Optional[np.random.Generator] = None,
                  flip: bool = True, jitter: float = 0.2,
                  crop_scale: Tuple[float, float] = (0.8, 1.0)) -> np.ndarray:
    """Light training augmentation (the role of an imgaug +
    RandAugment pipelines, vision_processor.py / randaugment.py): random
    resized crop, horizontal flip, brightness/contrast jitter. uint8 HWC in,
    float32 HWC out in [0, 255]."""
    rng = rng or np.random.default_rng()
    h, w = img.shape[:2]
    out = img.astype(np.float32)
    # random resized crop
    scale = rng.uniform(*crop_scale)
    ch, cw = max(1, int(h * scale)), max(1, int(w * scale))
    y0 = rng.integers(0, h - ch + 1)
    x0 = rng.integers(0, w - cw + 1)
    out = _bilinear_resize(out[y0:y0 + ch, x0:x0 + cw], h, w)
    if flip and rng.random() < 0.5:
        out = out[:, ::-1]
    if jitter:
        out = out * rng.uniform(1 - jitter, 1 + jitter)          # brightness
        mean = out.mean(axis=(0, 1), keepdims=True)
        out = (out - mean) * rng.uniform(1 - jitter, 1 + jitter) + mean
    return np.clip(out, 0, 255)
