"""Swin Transformer backbone (counterpart of spider_tpu/models/swin.py):
Grounding DINO's image encoder (Swin-T: embed 96, depths 2/2/6/2, heads
3/6/12/24, window 7).

Channels-last, as the reference: ``forward`` takes [B, 3, H, W] and returns
the NHWC features of the stages in ``out_indices``. A block pads H and W up
to a multiple of its window, shifts every second block's windows by half a
window (``torch.roll``), masks attention between pixels the shift brought
together with -1e9, and adds the table relative-position bias. Attention is
the reference's einsum with that bias; the flash kernel takes no bias.
Names follow the JAX tree; LayerNorm's eps is 1e-6 (flax's default), GELU
the tanh form.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from spider_tpu_torch.models.imagebind import _same_pad

LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7
    patch_size: int = 4
    mlp_ratio: float = 4.0
    out_indices: Tuple[int, ...] = (1, 2, 3)
    dtype: torch.dtype = torch.float32


def swin_tiny() -> SwinConfig:
    return SwinConfig()


def swin_test() -> SwinConfig:
    return SwinConfig(embed_dim=16, depths=(1, 1, 2, 1), num_heads=(1, 2, 2, 4),
                      window_size=2)


def _window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[B, H, W, C] -> [B * nW, ws * ws, C], windows in row-major order per image."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)


def _window_reverse(windows: torch.Tensor, ws: int, B: int, H: int, W: int) -> torch.Tensor:
    C = windows.shape[-1]
    x = windows.reshape(B, H // ws, W // ws, ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


def _relative_index(ws: int) -> np.ndarray:
    """[ws*ws * ws*ws] rows of the bias table, the reference's rel_index."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    relative = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0) + ws - 1
    return (relative[..., 0] * (2 * ws - 1) + relative[..., 1]).reshape(-1)


def _shift_mask(Hp: int, Wp: int, ws: int, shift: int) -> torch.Tensor:
    """[nW, ws*ws, ws*ws] fp32: -1e9 between pixels of different regions of
    the shifted grid, 0 elsewhere (the reference's img_mask)."""
    img_mask = np.zeros((1, Hp, Wp, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[:, hs, wsl] = cnt
            cnt += 1
    mw = _window_partition(torch.from_numpy(img_mask), ws)[..., 0]
    return torch.where(mw[:, None, :] != mw[:, :, None], -1e9, 0.0)


class SwinBlock(nn.Module):
    """A (shifted-)window attention block at width `dim`. The bias table is
    made for `window_size`; an input smaller than the window (the reference
    then shrinks the window, and its table with it) is refused."""

    def __init__(self, dim: int, heads: int, window_size: int, shift: int,
                 mlp_ratio: float, dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.heads, self.window_size, self.shift = heads, window_size, shift
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS, **kw)
        for name in ("q", "k", "v", "proj"):
            setattr(self, name, nn.Linear(dim, dim, **kw))
        self.rel_pos_bias = nn.Parameter(torch.zeros(
            (2 * window_size - 1) ** 2, heads, dtype=torch.float32, device=device))
        self.register_buffer("rel_index", torch.from_numpy(_relative_index(window_size)).to(
            device=device), persistent=False)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS, **kw)
        self.fc1 = nn.Linear(dim, int(dim * mlp_ratio), **kw)
        self.fc2 = nn.Linear(int(dim * mlp_ratio), dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        ws = min(self.window_size, H, W)
        if ws != self.window_size:
            raise ValueError(f"a {H}x{W} map is smaller than the window {self.window_size}")
        shift = self.shift if ws < min(H, W) else 0
        pad_h, pad_w = (ws - H % ws) % ws, (ws - W % ws) % ws
        h = F.pad(self.norm1(x), (0, 0, 0, pad_w, 0, pad_h))
        Hp, Wp = H + pad_h, W + pad_w
        if shift:
            h = torch.roll(h, (-shift, -shift), dims=(1, 2))
        windows = _window_partition(h, ws)                   # [nB, ws*ws, C]
        nB, T = windows.shape[:2]
        D = C // self.heads
        split = lambda t: t.reshape(nB, T, self.heads, D).transpose(1, 2)
        qh, kh, vh = split(self.q(windows)), split(self.k(windows)), split(self.v(windows))
        bias = self.rel_pos_bias[self.rel_index].reshape(T, T, self.heads).permute(2, 0, 1)
        logits = torch.einsum("bhtd,bhsd->bhts", qh, kh) / (D ** 0.5)
        logits = logits + bias[None].to(logits.dtype)
        if shift:
            mask = _shift_mask(Hp, Wp, ws, shift).to(logits.device, logits.dtype)
            nW = mask.shape[0]
            logits = (logits.reshape(nB // nW, nW, self.heads, T, T)
                      + mask[None, :, None]).reshape(nB, self.heads, T, T)
        attn = torch.softmax(logits.float(), dim=-1)
        out = torch.einsum("bhts,bhsd->bhtd", attn.to(vh.dtype), vh)
        out = self.proj(out.transpose(1, 2).reshape(nB, T, C))
        h = _window_reverse(out, ws, B, Hp, Wp)
        if shift:
            h = torch.roll(h, (shift, shift), dims=(1, 2))
        x = x + h[:, :H, :W]
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x)), approximate="tanh"))


class PatchMerging(nn.Module):
    def __init__(self, dim: int, dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm = nn.LayerNorm(4 * dim, eps=LN_EPS, **kw)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class SwinTransformer(nn.Module):
    def __init__(self, cfg: SwinConfig, device=None):
        super().__init__()
        self.config = cfg
        kw = dict(dtype=cfg.dtype, device=device)
        p = cfg.patch_size
        self.patch_embed = nn.Conv2d(3, cfg.embed_dim, p, stride=p, **kw)
        self.patch_norm = nn.LayerNorm(cfg.embed_dim, eps=LN_EPS, **kw)
        dim = cfg.embed_dim
        for stage, depth in enumerate(cfg.depths):
            for blk in range(depth):
                shift = 0 if blk % 2 == 0 else cfg.window_size // 2
                setattr(self, f"stage{stage}_block{blk}",
                        SwinBlock(dim, cfg.num_heads[stage], cfg.window_size, shift,
                                  cfg.mlp_ratio, cfg.dtype, device))
            if stage in cfg.out_indices:
                setattr(self, f"out_norm{stage}", nn.LayerNorm(dim, eps=LN_EPS, **kw))
            if stage < len(cfg.depths) - 1:
                setattr(self, f"merge{stage}", PatchMerging(dim, cfg.dtype, device))
                dim *= 2

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x [B, 3, H, W] -> the NHWC features of the stages in out_indices."""
        cfg = self.config
        p = cfg.patch_size
        (pt, pb), (pl, pr) = _same_pad(x.shape[2], p, p), _same_pad(x.shape[3], p, p)
        x = self.patch_embed(F.pad(x.to(cfg.dtype), (pl, pr, pt, pb)))
        x = self.patch_norm(x.permute(0, 2, 3, 1))
        outs = []
        for stage, depth in enumerate(cfg.depths):
            for blk in range(depth):
                x = getattr(self, f"stage{stage}_block{blk}")(x)
            if stage in cfg.out_indices:
                outs.append(getattr(self, f"out_norm{stage}")(x))
            if stage < len(cfg.depths) - 1:
                x = getattr(self, f"merge{stage}")(x)
        return outs
