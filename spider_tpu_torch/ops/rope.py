"""Rotary position embeddings (RoPE) with Llama-3 frequency scaling
(counterpart of spider_tpu/ops/rope.py).

Functional: precompute inv_freq once; apply per call with integer positions
so the same code serves prefill (positions 0..T) and KV-cached decode
(position = cache offset)."""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch


def rope_inv_freq(head_dim: int, theta: float = 10000.0,
                  llama3_scaling: Optional[dict] = None,
                  device=None) -> torch.Tensor:
    """Inverse frequencies [head_dim / 2] fp32, optionally with
    Llama-3.1-style scaling.

    llama3_scaling keys: factor, low_freq_factor, high_freq_factor,
    original_max_position_embeddings.
    """
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                             device=device) / head_dim))
    if llama3_scaling:
        factor = llama3_scaling["factor"]
        low = llama3_scaling["low_freq_factor"]
        high = llama3_scaling["high_freq_factor"]
        orig = llama3_scaling["original_max_position_embeddings"]
        low_wavelen = orig / low
        high_wavelen = orig / high
        wavelen = 2.0 * math.pi / inv_freq
        smooth = (orig / wavelen - low) / (high - low)
        inv_freq = torch.where(
            wavelen > low_wavelen,
            inv_freq / factor,
            torch.where(wavelen < high_wavelen, inv_freq,
                        (1.0 - smooth) / factor * inv_freq + smooth * inv_freq))
    return inv_freq


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (x[..., :d/2], x[..., d/2:]) — HF Llama convention.

    x: [..., T, num_heads, head_dim]; positions: broadcastable to [..., T].
    """
    angles = positions[..., None].float() * inv_freq       # [..., T, d/2]
    cos = torch.cos(angles)[..., None, :]                   # [..., T, 1, d/2]
    sin = torch.sin(angles)[..., None, :]
    d2 = x.shape[-1] // 2
    x1f = x[..., :d2].float()
    x2f = x[..., d2:].float()
    out1 = x1f * cos - x2f * sin
    out2 = x2f * cos + x1f * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _mrope_streams(section, device) -> torch.Tensor:
    """[d2] int64: the position stream of each frequency, made once per
    (section, device). Built on the device from a per-call host tensor and a
    tensor-valued repeat_interleave, it cost two waits for the device in
    every call (four a layer of a decode step)."""
    return torch.tensor([i for i, n in enumerate(section) for _ in range(n)], device=device)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, inv_freq: torch.Tensor,
                section) -> torch.Tensor:
    """Multimodal 3-D RoPE (Qwen2-VL / Qwen2.5-Omni), counterpart of
    spider_tpu/ops/rope.py::apply_mrope.

    Frequency index i of head_dim/2 takes its angle from position stream
    sel[i] (temporal, height, width), `section` giving each stream's count
    (e.g. (16, 24, 24) for head_dim 128). Text tokens carry equal t/h/w
    positions, which is exactly apply_rope.

    x: [B, T, H, D]; positions: [3, B, T] int; section sums to D/2.
    """
    d2 = x.shape[-1] // 2
    if sum(section) != d2:
        raise ValueError(f"mrope section {tuple(section)} must sum to head_dim/2 = {d2}")
    angles = positions[..., None].float() * inv_freq                  # [3, B, T, d2]
    sel = _mrope_streams(tuple(section), x.device)                     # [d2]
    # The JAX form sums the three streams weighted by a one-hot of sel,
    # which picks one of them exactly; a gather picks the same bits.
    ang = torch.gather(angles.movedim(0, -1), -1,
                       sel.expand(*angles.shape[1:])[..., None])[..., 0]   # [B, T, d2]
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1f = x[..., :d2].float()
    x2f = x[..., d2:].float()
    out1 = x1f * cos - x2f * sin
    out2 = x2f * cos + x1f * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)
