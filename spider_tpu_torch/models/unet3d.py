"""Conditional 3-D UNet in PyTorch (counterpart of
spider_tpu/models/unet3d.py): the text-to-video denoiser of ZeroScope.

``forward`` takes and returns [B, F, H, W, C] latents, as the JAX module
does. Inside, spatial layers run on frames folded b-major into the batch
([B*F, C, H, W], row b*F + f), and temporal layers see [B, F, H*W, C] or
[B, C, F, H*W] views of the same data. Activations are stored channels-last
([B*F, H, W, C] in memory), as are the convolution weights, so the temporal
layers read the spatial layers' storage in place (``_video_view``) and every
convolution, norm and residual add sees one layout. Submodule names follow
the JAX parameter tree (``down_0_tconv_1.conv2``,
``mid_tattn.block_0.attn1_q``...).

Numerics held to the reference:
  * GroupNorm in TemporalConv (eps 1e-5) and TransformerTemporal (eps 1e-6)
    reduces over (F, H*W, C/g) per video, not per frame;
  * the frame-axis conv (_ShiftConvF, a kernel-3 conv over F with zero
    frames at the edges) is an ``nn.Conv2d`` with a (3, 1) kernel over
    (F, H*W), padding (1, 0);
  * TemporalBasicBlock's LayerNorms use Flax's default eps 1e-6 and its
    GEGLU the tanh form of GELU;
  * per-frame conditioning repeats each video's time embedding and text
    context F times (``repeat_interleave``), matching the b-major fold.
The frame-axis attention goes through ops/temporal_attention.py, which
launches the CUDA kernel on the card.

Frames split over ranks (``forward(..., sp_group=)``, the sharded video
denoise of pipelines/vd.py; inference only): each rank holds F / n
consecutive frames of every video, and the spatial layers run on them as
they are. The temporal GroupNorms take their moments over all F frames (a
two-pass mean and centred second moment in fp32, each summed over the
group); the frame conv takes one frame of halo from each neighbour (zeros
at the first and the last frame); a TransformerTemporal reshards once after
its norm from frames to pixels (every frame of P / n pixels, the split
allowed to be uneven), runs proj_in, its blocks and proj_out there, and
reshards back before the residual. The temporal attention's routing reads
the whole frame's P.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from spider_tpu_torch.common.profiler import span
from spider_tpu_torch.models.schedulers import timestep_embedding
from spider_tpu_torch.models.unet2d import ResnetBlock2D, Transformer2D, block_span_names
from spider_tpu_torch.ops.group_norm import group_norm
from spider_tpu_torch.ops.temporal_attention import temporal_attention
from spider_tpu_torch.parallel.collectives import (all_reduce_sum_, frame_halo,
                                                   frames_to_pixels, pixels_to_frames, size_of)


@dataclasses.dataclass(frozen=True)
class UNet3DConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    cross_attn_blocks: Tuple[bool, ...] = (True, True, True, False)
    layers_per_block: int = 2
    num_attention_heads: Tuple[int, ...] = (8, 8, 8, 8)
    cross_attention_dim: int = 1024
    norm_num_groups: int = 32
    dtype: torch.dtype = torch.float32


def unet3d_zeroscope() -> UNet3DConfig:
    return UNet3DConfig()


def unet3d_tiny(cross_attention_dim: int = 32) -> UNet3DConfig:
    return UNet3DConfig(block_out_channels=(16, 32), cross_attn_blocks=(True, True),
                        layers_per_block=1, num_attention_heads=(2, 2),
                        cross_attention_dim=cross_attention_dim, norm_num_groups=4)


def _video_view(x: torch.Tensor, frames: int) -> torch.Tensor:
    """[B*F, C, H, W] -> [B, C, F, H*W], a view: the layout in which a
    GroupNorm reduces per video and a (3, 1) conv runs over the frames. A
    channels-last x gives a channels-last view of its own storage; any other
    x a strided view, which the norms and convolutions read as it lies."""
    BF, C, H, W = x.shape
    return x.reshape(BF // frames, frames, C, H * W).transpose(1, 2)


def _frames_view(h: torch.Tensor, shape) -> torch.Tensor:
    """[B, C, F, H*W] -> [B*F, C, H, W]."""
    return h.transpose(1, 2).reshape(shape)


def group_norm_frames(h: torch.Tensor, norm: nn.GroupNorm, group) -> torch.Tensor:
    """``norm`` of [B, C, F_local, P] with the moments of each (video,
    group of channels) taken over the frames of every rank of `group`: the
    mean, then the centred second moment, each summed over the ranks, in
    fp32; the affine in fp32, the result in h's dtype."""
    B, C, Fl, P = h.shape
    G = norm.num_groups
    x = h.float().reshape(B, G, -1)
    count = x.shape[-1] * size_of(group)
    s = x.sum(-1)
    all_reduce_sum_([s], group)
    d = x - (s / count)[..., None]
    v = (d * d).sum(-1)
    all_reduce_sum_([v], group)
    y = (d * torch.rsqrt(v / count + norm.eps)[..., None]).reshape(B, C, Fl, P)
    y = y * norm.weight.float()[:, None, None] + norm.bias.float()[:, None, None]
    return y.to(h.dtype)


class TemporalConv(nn.Module):
    """diffusers TemporalConvLayer: 4 x (GroupNorm -> SiLU -> conv over F),
    residual; the reference zero-inits the last conv."""

    def __init__(self, ch: int, groups: int, dt, device=None):
        super().__init__()
        for i in range(1, 5):
            self.add_module(f"norm{i}", nn.GroupNorm(groups, ch, eps=1e-5, dtype=dt,
                                                     device=device))
            self.add_module(f"conv{i}", nn.Conv2d(ch, ch, (3, 1), padding=(1, 0), dtype=dt,
                                                  device=device))

    def forward(self, x: torch.Tensor, frames: int, group=None) -> torch.Tensor:
        """frames: this rank's; group: the ranks holding the others (None:
        all frames here)."""
        h = _video_view(x, frames)
        for i in range(1, 5):
            norm, conv = getattr(self, f"norm{i}"), getattr(self, f"conv{i}")
            if group is None:
                h = conv(group_norm(h, norm, silu=True))
            else:
                h = F.silu(group_norm_frames(h, norm, group))
                h = F.conv2d(frame_halo(h, group, 2), conv.weight, conv.bias)
        return x + _frames_view(h, x.shape)


class TemporalBasicBlock(nn.Module):
    """BasicTransformerBlock over the frame axis on [B, F, P, C]: attn1 and
    attn2 are both self-attention (no temporal context)."""

    def __init__(self, ch: int, heads: int, dt, device=None):
        super().__init__()
        self.heads = heads
        lin = lambda bias: nn.Linear(ch, ch, bias=bias, dtype=dt, device=device)
        for name in ("attn1", "attn2"):
            for proj in ("q", "k", "v"):
                self.add_module(f"{name}_{proj}", lin(False))
            self.add_module(f"{name}_out", lin(True))
        for i in (1, 2, 3):
            self.add_module(f"norm{i}", nn.LayerNorm(ch, eps=1e-6, dtype=dt, device=device))
        self.ff_proj_in = nn.Linear(ch, ch * 8, dtype=dt, device=device)
        self.ff_proj_out = nn.Linear(ch * 4, ch, dtype=dt, device=device)

    def _attn(self, name: str, x: torch.Tensor, pixels) -> torch.Tensor:
        proj = lambda p: getattr(self, f"{name}_{p}")(x)
        out = temporal_attention(proj("q"), proj("k"), proj("v"), self.heads, layout="bfpc",
                                 pixels=pixels)
        return getattr(self, f"{name}_out")(out)

    def forward(self, h: torch.Tensor, pixels=None) -> torch.Tensor:
        """pixels: the whole frame's P where h holds a rank's share."""
        h = h + self._attn("attn1", self.norm1(h), pixels)
        h = h + self._attn("attn2", self.norm2(h), pixels)
        a, b = self.ff_proj_in(self.norm3(h)).chunk(2, dim=-1)
        return h + self.ff_proj_out(a * F.gelu(b, approximate="tanh"))


class TransformerTemporal(nn.Module):
    """diffusers TransformerTemporalModel: GroupNorm (per video) -> proj_in
    -> blocks over frames -> proj_out, residual."""

    def __init__(self, ch: int, heads: int, groups: int, dt, device=None, depth: int = 1):
        super().__init__()
        self.depth = depth
        self.norm = nn.GroupNorm(groups, ch, eps=1e-6, dtype=dt, device=device)
        self.proj_in = nn.Linear(ch, ch, dtype=dt, device=device)
        for i in range(depth):
            self.add_module(f"block_{i}", TemporalBasicBlock(ch, heads, dt, device))
        self.proj_out = nn.Linear(ch, ch, dtype=dt, device=device)

    def forward(self, x: torch.Tensor, frames: int, group=None) -> torch.Tensor:
        """frames: this rank's; group: the ranks holding the others (None:
        all frames here)."""
        BF, C, H, W = x.shape
        if group is not None:
            h = group_norm_frames(_video_view(x, frames), self.norm, group)
            h = frames_to_pixels(h.permute(0, 2, 3, 1), group)     # [B, F, P/n, C]
            h = self.proj_in(h)
            for i in range(self.depth):
                h = getattr(self, f"block_{i}")(h, pixels=H * W)
            h = pixels_to_frames(self.proj_out(h), group, H * W)   # [B, F_local, P, C]
            return x + h.permute(0, 1, 3, 2).reshape(BF, C, H, W)
        h = group_norm(_video_view(x, frames), self.norm)  # [B, C, F, P]
        h = self.proj_in(h.permute(0, 2, 3, 1))            # [B, F, P, C]
        for i in range(self.depth):
            h = getattr(self, f"block_{i}")(h)
        h = self.proj_out(h)
        return x + h.permute(0, 1, 3, 2).reshape(BF, C, H, W)


class UNet3DConditionModel(nn.Module):
    def __init__(self, cfg: UNet3DConfig, device=None):
        super().__init__()
        self.config = cfg
        dt, g = cfg.dtype, cfg.norm_num_groups
        chs = cfg.block_out_channels
        heads = cfg.num_attention_heads
        ctx = cfg.cross_attention_dim
        tdim = chs[0] * 4
        self.down_spans, self.up_spans = block_span_names(len(chs))

        self.time_embed_1 = nn.Linear(chs[0], tdim, dtype=dt, device=device)
        self.time_embed_2 = nn.Linear(tdim, tdim, dtype=dt, device=device)
        self.conv_in = nn.Conv2d(cfg.in_channels, chs[0], 3, padding=1, dtype=dt, device=device)
        self.transformer_in = TransformerTemporal(chs[0], heads[0], g, dt, device)
        cur = chs[0]
        skips = [cur]
        for i, ch in enumerate(chs):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{i}_res_{j}", ResnetBlock2D(cur, ch, g, tdim, dt, device))
                self.add_module(f"down_{i}_tconv_{j}", TemporalConv(ch, g, dt, device))
                cur = ch
                if cfg.cross_attn_blocks[i]:
                    self.add_module(f"down_{i}_attn_{j}",
                                    Transformer2D(ch, ctx, heads[i], 1, g, dt, device))
                    self.add_module(f"down_{i}_tattn_{j}",
                                    TransformerTemporal(ch, heads[i], g, dt, device))
                skips.append(ch)
            if i < len(chs) - 1:
                self.add_module(f"down_{i}_downsample", nn.Conv2d(
                    ch, ch, 3, stride=2, padding=1, dtype=dt, device=device))
                skips.append(ch)
        self.mid_res_0 = ResnetBlock2D(cur, cur, g, tdim, dt, device)
        self.mid_tconv_0 = TemporalConv(cur, g, dt, device)
        self.mid_attn = Transformer2D(cur, ctx, heads[-1], 1, g, dt, device)
        self.mid_tattn = TransformerTemporal(cur, heads[-1], g, dt, device)
        self.mid_res_1 = ResnetBlock2D(cur, cur, g, tdim, dt, device)
        self.mid_tconv_1 = TemporalConv(cur, g, dt, device)
        n = len(chs)
        for i, ch in enumerate(reversed(chs)):
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{i}_res_{j}",
                                ResnetBlock2D(cur + skips.pop(), ch, g, tdim, dt, device))
                self.add_module(f"up_{i}_tconv_{j}", TemporalConv(ch, g, dt, device))
                cur = ch
                if cfg.cross_attn_blocks[n - 1 - i]:
                    self.add_module(f"up_{i}_attn_{j}",
                                    Transformer2D(ch, ctx, heads[n - 1 - i], 1, g, dt, device))
                    self.add_module(f"up_{i}_tattn_{j}",
                                    TransformerTemporal(ch, heads[n - 1 - i], g, dt, device))
            if i < n - 1:
                self.add_module(f"up_{i}_upsample", nn.Conv2d(ch, ch, 3, padding=1, dtype=dt,
                                                              device=device))
        self.norm_out = nn.GroupNorm(g, cur, eps=1e-5, dtype=dt, device=device)
        self.conv_out = nn.Conv2d(cur, cfg.out_channels, 3, padding=1, dtype=dt, device=device)
        # channels-last like the activations; loaders copy into them in place
        self.to(memory_format=torch.channels_last)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor, sp_group=None) -> torch.Tensor:
        """sample [B,F,H,W,Cin]; timesteps [B]; encoder_hidden_states
        [B,S,Dctx] -> [B,F,H,W,Cout] in the model's dtype. With `sp_group`,
        F is this rank's consecutive frames of each video and the group's
        ranks hold the others, in rank order (inference only).

        The call is the span ``unet``; each level of blocks ``unet.down_<i>``,
        ``unet.mid``, ``unet.up_<i>``."""
        with span("unet"):
            return self._forward(sample, timesteps, encoder_hidden_states, sp_group)

    def _forward(self, sample, timesteps, encoder_hidden_states, sp_group):
        g = sp_group
        cfg = self.config
        dt = cfg.dtype
        n = len(cfg.block_out_channels)
        B, Fr, H, W, Cin = sample.shape
        temb = timestep_embedding(timesteps, cfg.block_out_channels[0]).to(dt)
        temb = self.time_embed_2(F.silu(self.time_embed_1(temb)))
        temb_f = temb.repeat_interleave(Fr, dim=0)                       # row b*F + f
        ctx_f = encoder_hidden_states.to(dt).repeat_interleave(Fr, dim=0)
        x = sample.to(dt).reshape(B * Fr, H, W, Cin).permute(0, 3, 1, 2)   # channels-last
        x = self.transformer_in(self.conv_in(x), Fr, g)
        skips = [x]
        for i in range(n):
            with span(self.down_spans[i]):
                for j in range(cfg.layers_per_block):
                    x = getattr(self, f"down_{i}_res_{j}")(x, temb_f)
                    x = getattr(self, f"down_{i}_tconv_{j}")(x, Fr, g)
                    if cfg.cross_attn_blocks[i]:
                        x = getattr(self, f"down_{i}_attn_{j}")(x, ctx_f)
                        x = getattr(self, f"down_{i}_tattn_{j}")(x, Fr, g)
                    skips.append(x)
                if i < n - 1:
                    x = getattr(self, f"down_{i}_downsample")(x)
                    skips.append(x)
        with span("unet.mid"):
            x = self.mid_tconv_0(self.mid_res_0(x, temb_f), Fr, g)
            x = self.mid_tattn(self.mid_attn(x, ctx_f), Fr, g)
            x = self.mid_tconv_1(self.mid_res_1(x, temb_f), Fr, g)
        for i in range(n):
            with span(self.up_spans[i]):
                for j in range(cfg.layers_per_block + 1):
                    x = getattr(self, f"up_{i}_res_{j}")(torch.cat([x, skips.pop()], dim=1),
                                                         temb_f)
                    x = getattr(self, f"up_{i}_tconv_{j}")(x, Fr, g)
                    if cfg.cross_attn_blocks[n - 1 - i]:
                        x = getattr(self, f"up_{i}_attn_{j}")(x, ctx_f)
                        x = getattr(self, f"up_{i}_tattn_{j}")(x, Fr, g)
                if i < n - 1:
                    x = getattr(self, f"up_{i}_upsample")(F.interpolate(x, scale_factor=2,
                                                                        mode="nearest"))
        x = self.conv_out(group_norm(x, self.norm_out, silu=True))
        return x.permute(0, 2, 3, 1).reshape(B, Fr, H, W, cfg.out_channels)
