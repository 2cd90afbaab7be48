"""Multi-scale deformable attention in plain PyTorch (counterpart of
spider_tpu/ops/msda.py), the Grounding DINO / deformable-DETR core op.

For each query, head, feature level and sampling point, the value map is
sampled bilinearly at a predicted fractional location and blended with the
predicted attention weights. As in the reference: the four corner gathers
per level, ``floor`` for the top-left corner, zero weight for a corner
outside the map (its index clamped into it), accumulation in fp32, and the
result in ``value``'s dtype. The reference has no Pallas kernel here (Pallas
could not express the gathers), so neither is there a CUDA kernel: this is
the form that runs on the card.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def msda_reference(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """value [B, S, H, D] (S = sum of h_l * w_l); sampling_locations
    [B, Q, H, L, P, 2] in [0, 1] (x, y per level); attention_weights
    [B, Q, H, L, P] (softmaxed over L * P) -> [B, Q, H * D]."""
    B, S, H, D = value.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    if sum(h * w for h, w in spatial_shapes) != S:
        raise ValueError(f"spatial shapes {spatial_shapes} do not cover {S} values")

    v = value.transpose(1, 2).float()                    # [B, H, S, D]
    out = torch.zeros((B, H, Q, D), dtype=torch.float32, device=value.device)
    offset = 0
    for l, (h_l, w_l) in enumerate(spatial_shapes):
        v_l = v[:, :, offset: offset + h_l * w_l]
        offset += h_l * w_l
        loc = sampling_locations[:, :, :, l]             # [B, Q, H, P, 2]
        x = loc[..., 0] * w_l - 0.5
        y = loc[..., 1] * h_l - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        wx = (x - x0).float().transpose(1, 2)[..., None]     # [B, H, Q, P, 1]
        wy = (y - y0).float().transpose(1, 2)[..., None]

        def corner(xi, yi):
            inside = (xi >= 0) & (xi < w_l) & (yi >= 0) & (yi < h_l)
            flat = (yi.clamp(0, h_l - 1).long() * w_l
                    + xi.clamp(0, w_l - 1).long())           # [B, Q, H, P]
            idx = flat.transpose(1, 2).reshape(B, H, Q * P, 1).expand(-1, -1, -1, D)
            g = torch.gather(v_l, 2, idx).reshape(B, H, Q, P, D)
            return g * inside.transpose(1, 2)[..., None]

        sampled = (corner(x0, y0) * (1 - wx) * (1 - wy) + corner(x0 + 1, y0) * wx * (1 - wy)
                   + corner(x0, y0 + 1) * (1 - wx) * wy + corner(x0 + 1, y0 + 1) * wx * wy)
        w = attention_weights[:, :, :, l].transpose(1, 2)[..., None]   # [B, H, Q, P, 1]
        out = out + (sampled * w).sum(dim=3)
    return out.transpose(1, 2).reshape(B, Q, H * D).to(value.dtype)


def msda(value, spatial_shapes, sampling_locations, attention_weights):
    return msda_reference(value, spatial_shapes, sampling_locations, attention_weights)
