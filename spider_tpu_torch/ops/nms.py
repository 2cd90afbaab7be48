"""Non-maximum suppression in plain PyTorch (counterpart of
spider_tpu/ops/nms.py): greedy, with a static output count, padded with -1.

The order is the reference's: ``jnp.argsort`` is stable, so the scores are
sorted with ``torch.argsort(stable=True)`` and tied boxes keep their input
order. The greedy pass runs on the boxes' device without a host round trip.
"""

from __future__ import annotations

import torch


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [N, 4], b [M, 4] xyxy -> IoU [N, M]."""
    area_a = (a[:, 2] - a[:, 0]).clamp_min(0) * (a[:, 3] - a[:, 1]).clamp_min(0)
    area_b = (b[:, 2] - b[:, 0]).clamp_min(0) * (b[:, 3] - b[:, 1]).clamp_min(0)
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / union.clamp_min(1e-9)


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.5,
        max_outputs: int = 100) -> torch.Tensor:
    """Indices into `boxes` of the kept boxes by descending score
    ([min(max_outputs, N)], int64, padded with -1): a box is suppressed when
    a higher-ranked kept box overlaps it by more than `iou_threshold`."""
    n = boxes.shape[0]
    order = torch.argsort(-scores, stable=True)
    iou = box_iou(boxes[order], boxes[order])
    earlier = torch.ones((n, n), dtype=torch.bool, device=boxes.device).tril(-1)
    over = (iou > iou_threshold) & earlier
    keep = torch.zeros((n,), dtype=torch.bool, device=boxes.device)
    for i in range(n):
        keep[i] = ~(over[i] & keep).any()
    kept_scores = torch.where(keep, scores[order], float("-inf"))
    top = torch.argsort(-kept_scores, stable=True)[:max_outputs]
    valid = kept_scores[top] > float("-inf")
    return torch.where(valid, order[top], -1)


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor, class_ids: torch.Tensor,
                iou_threshold: float = 0.5, max_outputs: int = 100) -> torch.Tensor:
    """Class-aware NMS by the coordinate-offset trick (mmcv batched_nms):
    boxes of different classes are moved apart so they never overlap."""
    offset = class_ids.to(boxes.dtype)[:, None] * (boxes.max() - boxes.min() + 1.0)
    return nms(boxes + offset, scores, iou_threshold, max_outputs)
