"""Video preprocessing: frame sampling into ImageBind-style clip stacks
(a copy of spider_tpu/processors/video.py)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from spider_tpu_torch.processors.vision import clip_image_transform


def sample_clip_indices(num_frames: int, num_clips: int = 5,
                        frames_per_clip: int = 2) -> np.ndarray:
    """Evenly spaced clip start indices -> [num_clips, frames_per_clip]."""
    if num_frames <= 0:
        raise ValueError("empty video")
    starts = np.linspace(0, max(num_frames - frames_per_clip, 0),
                         num_clips).astype(int)
    offsets = np.arange(frames_per_clip)
    idx = starts[:, None] + offsets[None, :]
    return np.clip(idx, 0, num_frames - 1)


def video_to_clips(frames: np.ndarray, num_clips: int = 5,
                   frames_per_clip: int = 2, size: int = 224) -> np.ndarray:
    """frames [T, H, W, 3] uint8 -> [num_clips, 3, frames_per_clip, size,
    size] normalized clip tubes (the 5-D layout ImageBind's vision trunk
    flattens and mean-reduces, imagebind_model.py:458-488)."""
    idx = sample_clip_indices(len(frames), num_clips, frames_per_clip)
    clips = []
    for clip_idx in idx:
        imgs = [clip_image_transform(frames[i], size) for i in clip_idx]
        clips.append(np.stack(imgs, axis=1))  # [3, F, size, size]
    return np.stack(clips, axis=0)


def read_video_frames(path: str, max_frames: int = 64) -> Optional[np.ndarray]:
    """Best-effort video decode via imageio if present; None otherwise."""
    try:
        import imageio.v3 as iio

        frames = iio.imread(path, plugin="pyav")
        return np.asarray(frames[:max_frames])
    except Exception:
        return None
