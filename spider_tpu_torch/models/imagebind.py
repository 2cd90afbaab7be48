"""ImageBind-class joint-embedding encoder: Spider's frozen input encoder
(counterpart of spider_tpu/models/imagebind.py). A vision trunk (images and
video clips) and an audio trunk (mel spectrograms) project into one joint
space.

Vision = ViT-H/14 over 2-frame tubes: images are repeated to 2 frames, videos
arrive as stacks of clips that flatten through the trunk and mean-reduce over
clips. Audio = a ViT over 16x16 mel patches at stride 10. Inputs keep the
channels-first layout of the sample dicts ([B,3,F,H,W], [B,1,M,T]); the flax
module transposes to channels-last for its convolutions, ``nn.Conv3d`` and
``nn.Conv2d`` take them as they are. The flax convolutions pad 'SAME'
(flax's default): the audio patch grid is ceil(M/10) x ceil(T/10), padded
here explicitly. Names follow the flax tree; GELU is the tanh form and
LayerNorm's eps 1e-6, flax's defaults. Attention is
``ops.attention.plain_attention``: 257 vision tokens stay on the einsum.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from spider_tpu_torch.ops.attention import plain_attention


LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class TrunkConfig:
    width: int
    layers: int
    heads: int
    pre_ln: bool = True


@dataclasses.dataclass(frozen=True)
class ImageBindConfig:
    embed_dim: int = 1024                       # joint space
    vision: TrunkConfig = TrunkConfig(1280, 32, 16)
    audio: TrunkConfig = TrunkConfig(768, 12, 12)
    image_size: int = 224
    patch_size: int = 14
    video_frames: int = 2
    audio_mel_bins: int = 128
    audio_target_len: int = 204
    audio_patch: int = 16
    audio_stride: int = 10
    dtype: torch.dtype = torch.float32


def imagebind_huge() -> ImageBindConfig:
    return ImageBindConfig()


def imagebind_tiny() -> ImageBindConfig:
    return ImageBindConfig(
        embed_dim=32,
        vision=TrunkConfig(48, 2, 2),
        audio=TrunkConfig(32, 2, 2),
        image_size=28, patch_size=14,
        audio_mel_bins=16, audio_target_len=20, audio_patch=16,
        audio_stride=10)


def _same_pad(n: int, k: int, s: int):
    """(before, after) padding of 'SAME' for length n, kernel k, stride s."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class ViTBlock(nn.Module):
    def __init__(self, width: int, heads: int, dtype, device=None):
        super().__init__()
        self.heads = heads
        kw = dict(dtype=dtype, device=device)
        self.ln1 = nn.LayerNorm(width, eps=LN_EPS, **kw)
        for name in ("q", "k", "v", "proj"):
            setattr(self, name, nn.Linear(width, width, **kw))
        self.ln2 = nn.LayerNorm(width, eps=LN_EPS, **kw)
        self.fc1 = nn.Linear(width, width * 4, **kw)
        self.fc2 = nn.Linear(width * 4, width, **kw)

    def forward(self, x):
        h = self.ln1(x)
        x = x + self.proj(plain_attention(self.q(h), self.k(h), self.v(h), self.heads))
        return x + self.fc2(F.gelu(self.fc1(self.ln2(x)), approximate="tanh"))


class Trunk(nn.Module):
    """tokens [B, T, width] (patch embeddings) -> [B, T + 1, width]; the cls
    token and the positions (cls + patches) are added here."""

    def __init__(self, cfg: TrunkConfig, num_tokens: int, dtype, device=None):
        super().__init__()
        self.dtype = dtype
        f32 = dict(dtype=torch.float32, device=device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.width, **f32))
        self.pos_embed = nn.Parameter(0.02 * torch.randn(1, num_tokens + 1, cfg.width, **f32))
        self.pre_ln = (nn.LayerNorm(cfg.width, eps=LN_EPS, dtype=dtype, device=device)
                       if cfg.pre_ln else None)
        for i in range(cfg.layers):
            setattr(self, f"block_{i}", ViTBlock(cfg.width, cfg.heads, dtype, device))
        self.layers = cfg.layers

    def forward(self, tokens):
        cls = self.cls_token.to(self.dtype).expand(tokens.shape[0], -1, -1)
        x = torch.cat([cls, tokens], dim=1) + self.pos_embed.to(self.dtype)
        if self.pre_ln is not None:
            x = self.pre_ln(x)
        for i in range(self.layers):
            x = getattr(self, f"block_{i}")(x)
        return x


class ImageBindEncoder(nn.Module):
    """forward(inputs: dict) -> dict of [B, embed_dim] joint embeddings.

    inputs keys (any subset): 'vision' [B,3,H,W], [B,3,F,H,W] or
    [B,Clips,3,F,H,W]; 'audio' [B,1,M,T] or [B,Clips,1,M,T].
    """

    def __init__(self, config: ImageBindConfig, device=None):
        super().__init__()
        cfg = self.config = config
        kw = dict(dtype=cfg.dtype, device=device)
        tube = (cfg.video_frames, cfg.patch_size, cfg.patch_size)
        self.vision_patch = nn.Conv3d(3, cfg.vision.width, tube, stride=tube, bias=False, **kw)
        self.vision_trunk = Trunk(cfg.vision, (cfg.image_size // cfg.patch_size) ** 2,
                                  cfg.dtype, device)
        self.vision_head_ln = nn.LayerNorm(cfg.vision.width, eps=LN_EPS, **kw)
        self.vision_head = nn.Linear(cfg.vision.width, cfg.embed_dim, bias=False, **kw)
        self.audio_patch = nn.Conv2d(1, cfg.audio.width, cfg.audio_patch,
                                     stride=cfg.audio_stride, bias=False, **kw)
        grid = (-(-cfg.audio_mel_bins // cfg.audio_stride)
                * -(-cfg.audio_target_len // cfg.audio_stride))
        self.audio_trunk = Trunk(cfg.audio, grid, cfg.dtype, device)
        self.audio_head_ln = nn.LayerNorm(cfg.audio.width, eps=LN_EPS, **kw)
        self.audio_head = nn.Linear(cfg.audio.width, cfg.embed_dim, bias=False, **kw)

    @staticmethod
    def _over_clips(x, single_ndim: int, encode):
        """Flatten a leading clips axis through `encode`, mean over clips."""
        if x.dim() == single_ndim:
            return encode(x)
        B, S = x.shape[:2]
        return encode(x.reshape(B * S, *x.shape[2:])).reshape(B, S, -1).mean(dim=1)

    def _encode_vision(self, x):
        cfg = self.config
        x = self.vision_patch(x.to(cfg.dtype))                    # [B, W, F', H', W']
        tokens = x.flatten(2).transpose(1, 2)
        cls = self.vision_trunk(tokens)[:, 0]
        return self.vision_head(self.vision_head_ln(cls))

    def _encode_audio(self, x):
        cfg = self.config
        k, s = cfg.audio_patch, cfg.audio_stride
        ph, pw = _same_pad(x.shape[2], k, s), _same_pad(x.shape[3], k, s)
        x = self.audio_patch(F.pad(x.to(cfg.dtype), (*pw, *ph)))  # [B, W, M', T']
        tokens = x.flatten(2).transpose(1, 2)
        cls = self.audio_trunk(tokens)[:, 0]
        return self.audio_head(self.audio_head_ln(cls))

    def forward(self, inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = {}
        v = inputs.get("vision")
        if v is not None:
            if v.dim() == 4:   # single image [B,3,H,W] -> repeat to the tube's frames
                v = v[:, :, None].repeat_interleave(self.config.video_frames, dim=2)
            out["vision"] = self._over_clips(v, 5, self._encode_vision)
        a = inputs.get("audio")
        if a is not None:
            out["audio"] = self._over_clips(a, 4, self._encode_audio)
        return out
