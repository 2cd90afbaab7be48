"""AutoencoderKL in PyTorch (counterpart of spider_tpu/models/vae.py): the
latent codec of SD-1.5 and SDXL, of ZeroScope (frame by frame) and, in 1-channel mel
form, of AudioLDM.

The public methods take and return NHWC tensors, as the JAX module does;
inside, the convolutions run in PyTorch's NCHW. Submodule names follow the
JAX parameter tree (``decoder.up_0_res_1.conv1``, ...). All GroupNorms use
eps=1e-6, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from spider_tpu_torch.ops.group_norm import group_norm


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    dtype: torch.dtype = torch.float32


def vae_sd() -> VAEConfig:
    return VAEConfig()


def vae_sdxl() -> VAEConfig:
    return VAEConfig(scaling_factor=0.13025)


def vae_audioldm() -> VAEConfig:
    """AudioLDM: 1-channel mel input, 8 latent channels, 2 blocks."""
    return VAEConfig(in_channels=1, out_channels=1, latent_channels=8,
                     block_out_channels=(128, 256), scaling_factor=0.9227914)


def vae_tiny() -> VAEConfig:
    return VAEConfig(block_out_channels=(8, 16), layers_per_block=1, norm_num_groups=4,
                     latent_channels=4)


def _conv(cin, cout, k, dt, device, stride=1, padding=0):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding, dtype=dt, device=device)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int, dt, device=None):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=1e-6, dtype=dt, device=device)
        self.conv1 = _conv(cin, cout, 3, dt, device, padding=1)
        self.norm2 = nn.GroupNorm(groups, cout, eps=1e-6, dtype=dt, device=device)
        self.conv2 = _conv(cout, cout, 3, dt, device, padding=1)
        self.conv_shortcut = _conv(cin, cout, 1, dt, device) if cin != cout else None

    def forward(self, x):
        h = self.conv1(group_norm(x, self.norm1, silu=True))
        h = self.conv2(group_norm(h, self.norm2, silu=True))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over the H*W positions; plain torch, as
    the reference keeps it an XLA einsum."""

    def __init__(self, ch: int, groups: int, dt, device=None):
        super().__init__()
        self.norm = nn.GroupNorm(groups, ch, eps=1e-6, dtype=dt, device=device)
        self.q = nn.Linear(ch, ch, dtype=dt, device=device)
        self.k = nn.Linear(ch, ch, dtype=dt, device=device)
        self.v = nn.Linear(ch, ch, dtype=dt, device=device)
        self.proj_out = nn.Linear(ch, ch, dtype=dt, device=device)

    def forward(self, x):
        B, C, H, W = x.shape
        h = group_norm(x, self.norm).permute(0, 2, 3, 1).reshape(B, H * W, C)
        q, k, v = self.q(h), self.k(h), self.v(h)
        attn = torch.softmax(torch.einsum("btc,bsc->bts", q, k).float() / (C ** 0.5),
                             dim=-1).to(v.dtype)
        h = self.proj_out(torch.einsum("bts,bsc->btc", attn, v))
        return x + h.reshape(B, H, W, C).permute(0, 3, 1, 2)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dt, g, chs = cfg.dtype, cfg.norm_num_groups, cfg.block_out_channels
        self.conv_in = _conv(cfg.in_channels, chs[0], 3, dt, device, padding=1)
        cur = chs[0]
        for i, ch in enumerate(chs):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{i}_res_{j}", ResnetBlock(cur, ch, g, dt, device))
                cur = ch
            if i < len(chs) - 1:
                self.add_module(f"down_{i}_downsample", _conv(ch, ch, 3, dt, device, stride=2))
        self.mid_res_0 = ResnetBlock(cur, cur, g, dt, device)
        self.mid_attn = AttnBlock(cur, g, dt, device)
        self.mid_res_1 = ResnetBlock(cur, cur, g, dt, device)
        self.norm_out = nn.GroupNorm(g, cur, eps=1e-6, dtype=dt, device=device)
        self.conv_out = _conv(cur, 2 * cfg.latent_channels, 3, dt, device, padding=1)
        self.quant_conv = _conv(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1, dt,
                                device)

    def forward(self, x):
        cfg = self.cfg
        x = self.conv_in(x)
        for i in range(len(cfg.block_out_channels)):
            for j in range(cfg.layers_per_block):
                x = getattr(self, f"down_{i}_res_{j}")(x)
            if i < len(cfg.block_out_channels) - 1:
                # Flax pads (0, 1) on each spatial axis before the stride-2 conv.
                x = getattr(self, f"down_{i}_downsample")(F.pad(x, (0, 1, 0, 1)))
        x = self.mid_res_1(self.mid_attn(self.mid_res_0(x)))
        x = self.conv_out(group_norm(x, self.norm_out, silu=True))
        mean, logvar = self.quant_conv(x).chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dt, g, chs = cfg.dtype, cfg.norm_num_groups, cfg.block_out_channels
        lc = cfg.latent_channels
        self.post_quant_conv = _conv(lc, lc, 1, dt, device)
        cur = chs[-1]
        self.conv_in = _conv(lc, cur, 3, dt, device, padding=1)
        self.mid_res_0 = ResnetBlock(cur, cur, g, dt, device)
        self.mid_attn = AttnBlock(cur, g, dt, device)
        self.mid_res_1 = ResnetBlock(cur, cur, g, dt, device)
        for i, ch in enumerate(reversed(chs)):
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{i}_res_{j}", ResnetBlock(cur, ch, g, dt, device))
                cur = ch
            if i < len(chs) - 1:
                self.add_module(f"up_{i}_upsample", _conv(ch, ch, 3, dt, device, padding=1))
        self.norm_out = nn.GroupNorm(g, cur, eps=1e-6, dtype=dt, device=device)
        self.conv_out = _conv(cur, cfg.out_channels, 3, dt, device, padding=1)

    def forward(self, z):
        cfg = self.cfg
        x = self.conv_in(self.post_quant_conv(z))
        x = self.mid_res_1(self.mid_attn(self.mid_res_0(x)))
        n = len(cfg.block_out_channels)
        for i in range(n):
            for j in range(cfg.layers_per_block + 1):
                x = getattr(self, f"up_{i}_res_{j}")(x)
            if i < n - 1:
                x = getattr(self, f"up_{i}_upsample")(F.interpolate(x, scale_factor=2,
                                                                    mode="nearest"))
        return self.conv_out(group_norm(x, self.norm_out, silu=True))


def _nchw(x):
    return x.permute(0, 3, 1, 2).contiguous()


def _nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig, device=None):
        super().__init__()
        self.config = cfg
        self.encoder = Encoder(cfg, device)
        self.decoder = Decoder(cfg, device)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, C] -> scaled latent means [B, h, w, latent_channels]
        (sampling from the posterior is not ported yet)."""
        mean, _ = self.encoder(_nchw(x.to(self.config.dtype)))
        return _nhwc(mean) * self.config.scaling_factor

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latents [B, h, w, C] -> image [B, H, W, out_channels]."""
        return _nhwc(self.decoder(_nchw((z / self.config.scaling_factor)
                                        .to(self.config.dtype))))
