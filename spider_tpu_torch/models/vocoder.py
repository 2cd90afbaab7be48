"""HiFi-GAN vocoder in PyTorch (counterpart of spider_tpu/models/vocoder.py):
mel-spectrogram -> waveform, the last stage of the AudioLDM pipeline.

``forward`` takes [B, T, n_mels] and returns [B, T'] as the JAX module does;
inside, the 1-D convolutions run in PyTorch's [B, C, T]. Submodule names
follow the JAX parameter tree (``up_<i>``, ``res_<i>_<j>.conv1_<k>``, the raw
``mean`` and ``scale``). The reference computes the vocoder in fp32
(``hifigan_audioldm`` keeps dtype float32), and so does this port.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from spider_tpu_torch.ops.convs import ConvTranspose1dTorch


@dataclasses.dataclass(frozen=True)
class HifiGanConfig:
    model_in_dim: int = 64              # mel bins
    upsample_initial_channel: int = 1024
    upsample_rates: Tuple[int, ...] = (5, 4, 2, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 8, 4, 4)
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5),) * 3
    leaky_relu_slope: float = 0.1
    normalize_before: bool = True
    dtype: torch.dtype = torch.float32


def hifigan_audioldm() -> HifiGanConfig:
    return HifiGanConfig()


def hifigan_tiny() -> HifiGanConfig:
    return HifiGanConfig(model_in_dim=8, upsample_initial_channel=16, upsample_rates=(2, 2),
                         upsample_kernel_sizes=(4, 4), resblock_kernel_sizes=(3,),
                         resblock_dilation_sizes=((1, 3),))


def output_length(cfg: HifiGanConfig, frames: int) -> int:
    """Waveform samples for `frames` mel frames: each upsample stage maps T
    to (T - 1) * s + k - 2 * ((k - s) // 2)."""
    for s, k in zip(cfg.upsample_rates, cfg.upsample_kernel_sizes):
        frames = (frames - 1) * s + k - 2 * ((k - s) // 2)
    return frames


def _same_conv(cin: int, cout: int, k: int, dt, device, dilation: int = 1) -> nn.Conv1d:
    """flax padding="SAME" for an odd kernel."""
    return nn.Conv1d(cin, cout, k, dilation=dilation, padding=dilation * (k - 1) // 2,
                     dtype=dt, device=device)


class ResBlock1D(nn.Module):
    def __init__(self, channels: int, kernel_size: int, dilations: Tuple[int, ...],
                 slope: float, dt, device=None):
        super().__init__()
        self.n = len(dilations)
        self.slope = slope
        for i, d in enumerate(dilations):
            self.add_module(f"conv1_{i}", _same_conv(channels, channels, kernel_size, dt,
                                                     device, dilation=d))
            self.add_module(f"conv2_{i}", _same_conv(channels, channels, kernel_size, dt,
                                                     device))

    def forward(self, x):
        for i in range(self.n):
            h = getattr(self, f"conv1_{i}")(F.leaky_relu(x, self.slope))
            x = x + getattr(self, f"conv2_{i}")(F.leaky_relu(h, self.slope))
        return x


class HifiGan(nn.Module):
    """mel [B, T, n_mels] -> waveform [B, output_length(cfg, T)]."""

    def __init__(self, cfg: HifiGanConfig, device=None):
        super().__init__()
        self.config = cfg
        dt = cfg.dtype
        if cfg.normalize_before:
            self.mean = nn.Parameter(torch.zeros(cfg.model_in_dim, dtype=dt, device=device))
            self.scale = nn.Parameter(torch.ones(cfg.model_in_dim, dtype=dt, device=device))
        self.conv_pre = _same_conv(cfg.model_in_dim, cfg.upsample_initial_channel, 7, dt,
                                   device)
        ch = cfg.upsample_initial_channel
        for i, (rate, ksize) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            self.add_module(f"up_{i}", ConvTranspose1dTorch(ch, ch // 2, ksize, rate, dtype=dt,
                                                            device=device))
            ch //= 2
            for j, (k, ds) in enumerate(zip(cfg.resblock_kernel_sizes,
                                            cfg.resblock_dilation_sizes)):
                self.add_module(f"res_{i}_{j}", ResBlock1D(ch, k, tuple(ds),
                                                           cfg.leaky_relu_slope, dt, device))
        self.conv_post = _same_conv(ch, 1, 7, dt, device)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        x = mel.to(cfg.dtype)
        if cfg.normalize_before:
            x = (x - self.mean) / self.scale
        x = self.conv_pre(x.transpose(1, 2))
        n_res = len(cfg.resblock_kernel_sizes)
        for i in range(len(cfg.upsample_rates)):
            x = getattr(self, f"up_{i}")(F.leaky_relu(x, cfg.leaky_relu_slope))
            acc = getattr(self, f"res_{i}_0")(x)
            for j in range(1, n_res):
                acc = acc + getattr(self, f"res_{i}_{j}")(x)
            x = acc / n_res
        x = self.conv_post(F.leaky_relu(x, cfg.leaky_relu_slope))
        return torch.tanh(x)[:, 0]
