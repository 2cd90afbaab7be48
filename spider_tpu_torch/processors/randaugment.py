"""RandAugment in numpy (a copy of spider_tpu/processors/randaugment.py):
the 14 ops of the BLIP-style caption processors (N=2, M=5) with their
level-to-argument rules (enhance factor = level/10*1.8+0.1, shear
+-level/10*0.3, translate +-level/10*const, solarize level/10*256, posterize
level/10*4 bits, rotate +-level/10*30 degrees, cutout level/10*const), on
bilinear inverse-map affine warps instead of cv2, so the data layer needs
nothing but numpy.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

Fill = Tuple[int, int, int]


def _affine_inverse_warp(img: np.ndarray, inv: np.ndarray,
                         fill: Fill) -> np.ndarray:
    """Bilinear sample img at inv @ [x, y, 1] for each output pixel."""
    h, w = img.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    sx = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    sy = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
    valid = (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)
    x0c = np.clip(np.floor(sx).astype(np.int32), 0, w - 2)
    y0c = np.clip(np.floor(sy).astype(np.int32), 0, h - 2)
    fx = (sx - x0c)[..., None]      # relative to the CLIPPED base so the
    fy = (sy - y0c)[..., None]      # last row/col interpolate exactly
    f = img.astype(np.float32)
    out = (f[y0c, x0c] * (1 - fx) * (1 - fy)
           + f[y0c, x0c + 1] * fx * (1 - fy)
           + f[y0c + 1, x0c] * (1 - fx) * fy
           + f[y0c + 1, x0c + 1] * fx * fy)
    out = np.where(valid[..., None], out,
                   np.asarray(fill, np.float32)[None, None])
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def identity(img):
    return img


def autocontrast(img, cutoff: int = 0):
    out = np.empty_like(img)
    for c in range(img.shape[2]):
        ch = img[..., c]
        lo, hi = int(ch.min()), int(ch.max())
        if hi <= lo:
            out[..., c] = ch
            continue
        table = np.clip((np.arange(256) - lo) * (255.0 / (hi - lo)),
                        0, 255).astype(np.uint8)
        out[..., c] = table[ch]
    return out


def equalize(img):
    out = np.empty_like(img)
    for c in range(img.shape[2]):
        ch = img[..., c]
        hist = np.bincount(ch.reshape(-1), minlength=256)
        nonzero = hist[hist > 0]
        if len(nonzero) <= 1:
            out[..., c] = ch
            continue
        step = (hist.sum() - nonzero[-1]) // 255
        if step == 0:
            out[..., c] = ch
            continue
        lut = (np.cumsum(hist) - hist) // step
        out[..., c] = np.clip(lut, 0, 255).astype(np.uint8)[ch]
    return out


def rotate(img, degrees: float, fill: Fill = (0, 0, 0)):
    h, w = img.shape[:2]
    a = np.deg2rad(degrees)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    cos, sin = np.cos(a), np.sin(a)
    # inverse rotation about the center
    inv = np.array([[cos, -sin, cx - cos * cx + sin * cy],
                    [sin, cos, cy - sin * cx - cos * cy]], np.float32)
    return _affine_inverse_warp(img, inv, fill)


def solarize(img, thresh: int = 128):
    return np.where(img < thresh, img, 255 - img.astype(np.int32)) \
        .astype(np.uint8)


def _blend(a: np.ndarray, b: np.ndarray, factor: float) -> np.ndarray:
    out = b.astype(np.float32) + factor * (a.astype(np.float32)
                                           - b.astype(np.float32))
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def color(img, factor: float):
    gray = (img @ np.asarray([0.299, 0.587, 0.114], np.float32))
    return _blend(img, np.repeat(gray[..., None], 3, axis=2), factor)


def contrast(img, factor: float):
    gray = img @ np.asarray([0.299, 0.587, 0.114], np.float32)
    mean = np.full_like(img, int(gray.mean() + 0.5), dtype=np.uint8)
    return _blend(img, mean, factor)


def brightness(img, factor: float):
    return _blend(img, np.zeros_like(img), factor)


def sharpness(img, factor: float):
    kern = np.array([[1, 1, 1], [1, 5, 1], [1, 1, 1]], np.float32) / 13.0
    f = img.astype(np.float32)
    pad = np.pad(f, ((1, 1), (1, 1), (0, 0)), mode="edge")
    blur = sum(kern[i, j] * pad[i:i + f.shape[0], j:j + f.shape[1]]
               for i in range(3) for j in range(3))
    blur = np.clip(np.round(blur), 0, 255).astype(np.uint8)
    # interior smoothing only (PIL keeps the border unsmoothed)
    blur[0], blur[-1], blur[:, 0], blur[:, -1] = \
        img[0], img[-1], img[:, 0], img[:, -1]
    return _blend(img, blur, factor)


def shear_x(img, factor: float, fill: Fill = (0, 0, 0)):
    inv = np.array([[1.0, factor, 0.0], [0.0, 1.0, 0.0]], np.float32)
    return _affine_inverse_warp(img, inv, fill)


def shear_y(img, factor: float, fill: Fill = (0, 0, 0)):
    inv = np.array([[1.0, 0.0, 0.0], [factor, 1.0, 0.0]], np.float32)
    return _affine_inverse_warp(img, inv, fill)


def translate_x(img, offset: float, fill: Fill = (0, 0, 0)):
    inv = np.array([[1.0, 0.0, offset], [0.0, 1.0, 0.0]], np.float32)
    return _affine_inverse_warp(img, inv, fill)


def translate_y(img, offset: float, fill: Fill = (0, 0, 0)):
    inv = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, offset]], np.float32)
    return _affine_inverse_warp(img, inv, fill)


def posterize(img, bits: int):
    if bits >= 8:
        return img
    mask = np.uint8((0xFF << (8 - max(bits, 1))) & 0xFF)
    return (img & mask).astype(np.uint8)


def cutout(img, pad_size: int, replace: Fill = (128, 128, 128),
           rng: Optional[np.random.Generator] = None):
    if pad_size <= 0:
        return img
    rng = rng or np.random.default_rng()
    h, w = img.shape[:2]
    cy, cx = int(rng.integers(0, h)), int(rng.integers(0, w))
    y0, y1 = max(cy - pad_size, 0), min(cy + pad_size, h)
    x0, x1 = max(cx - pad_size, 0), min(cx + pad_size, w)
    out = img.copy()
    out[y0:y1, x0:x1] = np.asarray(replace, np.uint8)
    return out


MAX_LEVEL = 10
_FILL: Fill = (128, 128, 128)


def _enhance(level):
    return ((level / MAX_LEVEL) * 1.8 + 0.1,)


OPS = {
    "Identity": (identity, lambda l, rng: ()),
    "AutoContrast": (autocontrast, lambda l, rng: ()),
    "Equalize": (equalize, lambda l, rng: ()),
    "Rotate": (rotate, lambda l, rng: (
        (l / MAX_LEVEL) * 30 * (1 if rng.random() < 0.5 else -1), _FILL)),
    "Solarize": (solarize, lambda l, rng: (int(l / MAX_LEVEL * 256),)),
    "Color": (color, lambda l, rng: _enhance(l)),
    "Contrast": (contrast, lambda l, rng: _enhance(l)),
    "Brightness": (brightness, lambda l, rng: _enhance(l)),
    "Sharpness": (sharpness, lambda l, rng: _enhance(l)),
    "ShearX": (shear_x, lambda l, rng: (
        (l / MAX_LEVEL) * 0.3 * (1 if rng.random() < 0.5 else -1), _FILL)),
    "ShearY": (shear_y, lambda l, rng: (
        (l / MAX_LEVEL) * 0.3 * (1 if rng.random() < 0.5 else -1), _FILL)),
    "TranslateX": (translate_x, lambda l, rng: (
        (l / MAX_LEVEL) * 10 * (1 if rng.random() < 0.5 else -1), _FILL)),
    "TranslateY": (translate_y, lambda l, rng: (
        (l / MAX_LEVEL) * 10 * (1 if rng.random() < 0.5 else -1), _FILL)),
    "Posterize": (posterize, lambda l, rng: (int(l / MAX_LEVEL * 4),)),
}


class RandomAugment:
    """N randomly-chosen ops at level M, each applied with prob 0.5
    (BLIP processors use N=2, M=5 with the identity/autocontrast/equalize/
    brightness/sharpness/shear/translate/rotate subset)."""

    def __init__(self, N: int = 2, M: int = 10,
                 augs: Optional[Sequence[str]] = None,
                 rng: Optional[np.random.Generator] = None):
        self.N = N
        self.M = M
        self.augs = list(augs) if augs else list(OPS)
        self.rng = rng or np.random.default_rng()

    def __call__(self, img: np.ndarray) -> np.ndarray:
        img = np.ascontiguousarray(img)
        if img.dtype != np.uint8:
            img = np.clip(img, 0, 255).astype(np.uint8)
        names = self.rng.choice(self.augs, self.N)
        for name in names:
            if self.rng.random() > 0.5:
                continue
            fn, to_args = OPS[name]
            img = fn(img, *to_args(self.M, self.rng))
        return img


class VideoRandomAugment:
    """Per-clip RandAugment: ONE op set sampled per clip (without
    replacement), applied per-frame with keep-probability 1-p, on numpy
    [F, H, W, 3]."""

    def __init__(self, N: int = 2, M: int = 10, p: float = 0.0,
                 augs: Optional[Sequence[str]] = None,
                 rng: Optional[np.random.Generator] = None):
        self.N = N
        self.M = M
        self.p = p
        self.augs = list(augs) if augs else list(OPS)
        self.rng = rng or np.random.default_rng()

    def __call__(self, frames: np.ndarray) -> np.ndarray:
        assert frames.shape[-1] == 3, "expect [F, H, W, 3]"
        if frames.dtype != np.uint8:
            frames = np.clip(frames, 0, 255).astype(np.uint8)
        names = self.rng.choice(self.augs, self.N, replace=False)
        # apply/skip drawn ONCE per clip (the same apply_or_not across
        # frames) so augmentation stays temporally
        # coherent; op arguments are also fixed per clip for the same reason
        applied = [(OPS[n][0], OPS[n][1](self.M, self.rng)) for n in names
                   if self.rng.random() > self.p]
        out = []
        for img in frames:
            for fn, args in applied:
                img = fn(np.ascontiguousarray(img), *args)
            out.append(img)
        return np.stack(out).astype(np.float32)
