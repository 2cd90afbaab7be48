"""The conditional 2-D UNet (SD-1.5) and 3-D UNet (ZeroScope), plain fp32.

The layer equations are those the measured program computes (models/unet2d.py
and models/unet3d.py of the port), written here again with plain attention
and no kernel: NCHW inside, NHWC latents in and out; GroupNorm eps 1e-5 in
the resnets and temporal convolutions, 1e-6 in the transformers; LayerNorm
eps 1e-6; GEGLU with the tanh GELU; a 3-D UNet folds the frames b-major into
the batch for its spatial layers and normalises its temporal layers over
each whole video. Parameter names are those of the weights the benchmark
fills. ``PERF.md`` lists where these equations depart from the published
models.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.layers import Conv, Lin, attention, gelu_tanh


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """[B] -> [B, dim] fp32, cos first, frequencies exp(-ln(1e4) i / half)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                         device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class Resnet(nn.Module):
    def __init__(self, cin, cout, groups, tdim):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=1e-5)
        self.conv1 = Conv(cin, cout, 3, padding=1)
        self.time_emb_proj = Lin(tdim, cout)
        self.norm2 = nn.GroupNorm(groups, cout, eps=1e-5)
        self.conv2 = Conv(cout, cout, 3, padding=1)
        self.conv_shortcut = Conv(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class Attn(nn.Module):
    def __init__(self, ch, ctx, heads):
        super().__init__()
        self.heads = heads
        self.to_q = Lin(ch, ch, bias=False)
        self.to_k = Lin(ctx, ch, bias=False)
        self.to_v = Lin(ctx, ch, bias=False)
        self.to_out = Lin(ch, ch)

    def forward(self, x, context=None):
        c = x if context is None else context
        return self.to_out(attention(self.to_q(x), self.to_k(c), self.to_v(c), self.heads))


class FeedForward(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.proj_in = Lin(ch, ch * 8)
        self.proj_out = Lin(ch * 4, ch)

    def forward(self, x):
        a, b = self.proj_in(x).chunk(2, dim=-1)
        return self.proj_out(a * gelu_tanh(b))


class Block(nn.Module):
    def __init__(self, ch, ctx, heads):
        super().__init__()
        self.norm1 = nn.LayerNorm(ch, eps=1e-6)
        self.attn1 = Attn(ch, ch, heads)
        self.norm2 = nn.LayerNorm(ch, eps=1e-6)
        self.attn2 = Attn(ch, ctx, heads)
        self.norm3 = nn.LayerNorm(ch, eps=1e-6)
        self.ff = FeedForward(ch)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    def __init__(self, ch, ctx, heads, groups):
        super().__init__()
        self.norm = nn.GroupNorm(groups, ch, eps=1e-6)
        self.proj_in = Lin(ch, ch)
        self.block_0 = Block(ch, ctx, heads)
        self.proj_out = Lin(ch, ch)

    def forward(self, x, context):
        B, C, H, W = x.shape
        h = self.proj_in(self.norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C))
        h = self.proj_out(self.block_0(h, context))
        return x + h.reshape(B, H, W, C).permute(0, 3, 1, 2)


def video_view(x, frames):
    """[B*F, C, H, W] -> [B, C, F, H*W]."""
    BF, C, H, W = x.shape
    return x.reshape(BF // frames, frames, C, H * W).transpose(1, 2)


class TemporalConv(nn.Module):
    def __init__(self, ch, groups):
        super().__init__()
        for i in range(1, 5):
            self.add_module(f"norm{i}", nn.GroupNorm(groups, ch, eps=1e-5))
            self.add_module(f"conv{i}", Conv(ch, ch, (3, 1), padding=(1, 0)))

    def forward(self, x, frames):
        h = video_view(x, frames)
        for i in range(1, 5):
            h = getattr(self, f"conv{i}")(F.silu(getattr(self, f"norm{i}")(h)))
        return x + h.transpose(1, 2).reshape(x.shape)


class TemporalBlock(nn.Module):
    """Two self-attentions over the frames at each pixel, then GEGLU, on
    [B, F, P, C]."""

    def __init__(self, ch, heads):
        super().__init__()
        self.heads = heads
        for name in ("attn1", "attn2"):
            for p in ("q", "k", "v"):
                self.add_module(f"{name}_{p}", Lin(ch, ch, bias=False))
            self.add_module(f"{name}_out", Lin(ch, ch))
        for i in (1, 2, 3):
            self.add_module(f"norm{i}", nn.LayerNorm(ch, eps=1e-6))
        self.ff_proj_in = Lin(ch, ch * 8)
        self.ff_proj_out = Lin(ch * 4, ch)

    def _attn(self, name, x):
        B, Fr, P, C = x.shape
        seq = lambda p: getattr(self, f"{name}_{p}")(x).transpose(1, 2).reshape(B * P, Fr, C)
        o = attention(seq("q"), seq("k"), seq("v"), self.heads)
        return getattr(self, f"{name}_out")(o.reshape(B, P, Fr, C).transpose(1, 2))

    def forward(self, h):
        h = h + self._attn("attn1", self.norm1(h))
        h = h + self._attn("attn2", self.norm2(h))
        a, b = self.ff_proj_in(self.norm3(h)).chunk(2, dim=-1)
        return h + self.ff_proj_out(a * gelu_tanh(b))


class TransformerTemporal(nn.Module):
    def __init__(self, ch, heads, groups):
        super().__init__()
        self.norm = nn.GroupNorm(groups, ch, eps=1e-6)
        self.proj_in = Lin(ch, ch)
        self.block_0 = TemporalBlock(ch, heads)
        self.proj_out = Lin(ch, ch)

    def forward(self, x, frames):
        BF, C, H, W = x.shape
        h = self.norm(video_view(x, frames))                   # [B, C, F, P]
        h = self.proj_out(self.block_0(self.proj_in(h.permute(0, 2, 3, 1))))
        return x + h.permute(0, 1, 3, 2).reshape(BF, C, H, W)


class UNet(nn.Module):
    """forward(sample, timesteps [B], context [B, S, ctx]) -> eps in the
    sample's layout: [B, H, W, C] for the 2-D UNet, [B, F, H, W, C] for the
    3-D one. ``cfg`` is the configuration file's "unet_as_run"."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        self.video = cfg["temporal"]
        chs, L = cfg["block_out_channels"], cfg["layers_per_block"]
        attn, heads = cfg["cross_attn_blocks"], cfg["num_attention_heads"]
        g, ctx = cfg["norm_num_groups"], cfg["cross_attention_dim"]
        tdim = chs[0] * 4
        self.time_embed_1 = Lin(chs[0], tdim)
        self.time_embed_2 = Lin(tdim, tdim)
        self.conv_in = Conv(cfg["in_channels"], chs[0], 3, padding=1)
        if self.video:
            self.transformer_in = TransformerTemporal(chs[0], heads[0], g)
        cur, skips, n = chs[0], [chs[0]], len(chs)
        for i, ch in enumerate(chs):
            for j in range(L):
                self.add_module(f"down_{i}_res_{j}", Resnet(cur, ch, g, tdim))
                if self.video:
                    self.add_module(f"down_{i}_tconv_{j}", TemporalConv(ch, g))
                cur = ch
                if attn[i]:
                    self.add_module(f"down_{i}_attn_{j}", Transformer2D(ch, ctx, heads[i], g))
                    if self.video:
                        self.add_module(f"down_{i}_tattn_{j}",
                                        TransformerTemporal(ch, heads[i], g))
                skips.append(ch)
            if i < n - 1:
                self.add_module(f"down_{i}_downsample", Conv(ch, ch, 3, stride=2, padding=1))
                skips.append(ch)
        self.mid_res_0 = Resnet(cur, cur, g, tdim)
        self.mid_res_1 = Resnet(cur, cur, g, tdim)
        self.has_mid_attn = cfg["mid_attention"]
        if self.has_mid_attn:
            self.mid_attn = Transformer2D(cur, ctx, heads[-1], g)
        if self.video:
            self.mid_tconv_0 = TemporalConv(cur, g)
            self.mid_tattn = TransformerTemporal(cur, heads[-1], g)
            self.mid_tconv_1 = TemporalConv(cur, g)
        for i, ch in enumerate(reversed(chs)):
            for j in range(L + 1):
                self.add_module(f"up_{i}_res_{j}", Resnet(cur + skips.pop(), ch, g, tdim))
                if self.video:
                    self.add_module(f"up_{i}_tconv_{j}", TemporalConv(ch, g))
                cur = ch
                if attn[n - 1 - i]:
                    self.add_module(f"up_{i}_attn_{j}",
                                    Transformer2D(ch, ctx, heads[n - 1 - i], g))
                    if self.video:
                        self.add_module(f"up_{i}_tattn_{j}",
                                        TransformerTemporal(ch, heads[n - 1 - i], g))
            if i < n - 1:
                self.add_module(f"up_{i}_upsample", Conv(ch, ch, 3, padding=1))
        self.norm_out = nn.GroupNorm(g, cur, eps=1e-5)
        self.conv_out = Conv(cur, cfg["out_channels"], 3, padding=1)

    def forward(self, sample, timesteps, context):
        cfg = self.cfg
        chs, L, attn = cfg["block_out_channels"], cfg["layers_per_block"], cfg["cross_attn_blocks"]
        n = len(chs)
        temb = self.time_embed_2(F.silu(self.time_embed_1(
            timestep_embedding(timesteps, chs[0]))))
        if self.video:
            B, Fr, H, W, Cin = sample.shape
            temb = temb.repeat_interleave(Fr, dim=0)
            context = context.repeat_interleave(Fr, dim=0)
            x = sample.reshape(B * Fr, H, W, Cin).permute(0, 3, 1, 2)
        else:
            Fr = 1
            x = sample.permute(0, 3, 1, 2)
        tconv = lambda name, x: getattr(self, name)(x, Fr) if self.video else x
        x = self.conv_in(x)
        x = tconv("transformer_in", x)
        skips = [x]
        for i in range(n):
            for j in range(L):
                x = tconv(f"down_{i}_tconv_{j}", getattr(self, f"down_{i}_res_{j}")(x, temb))
                if attn[i]:
                    x = tconv(f"down_{i}_tattn_{j}", getattr(self, f"down_{i}_attn_{j}")(x, context))
                skips.append(x)
            if i < n - 1:
                x = getattr(self, f"down_{i}_downsample")(x)
                skips.append(x)
        x = tconv("mid_tconv_0", self.mid_res_0(x, temb))
        if self.has_mid_attn:
            x = tconv("mid_tattn", self.mid_attn(x, context))
        x = tconv("mid_tconv_1", self.mid_res_1(x, temb))
        for i in range(n):
            for j in range(L + 1):
                x = getattr(self, f"up_{i}_res_{j}")(torch.cat([x, skips.pop()], dim=1), temb)
                x = tconv(f"up_{i}_tconv_{j}", x)
                if attn[n - 1 - i]:
                    x = tconv(f"up_{i}_tattn_{j}", getattr(self, f"up_{i}_attn_{j}")(x, context))
            if i < n - 1:
                x = getattr(self, f"up_{i}_upsample")(F.interpolate(x, scale_factor=2,
                                                                    mode="nearest"))
        x = self.conv_out(F.silu(self.norm_out(x))).permute(0, 2, 3, 1)
        return x.reshape(sample.shape[:-1] + (cfg["out_channels"],))
