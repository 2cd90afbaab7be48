"""Conditional 2-D UNet in PyTorch (counterpart of
spider_tpu/models/unet2d.py): the denoiser of SD-1.5, of SDXL (with the
text_time additional embedding and StoryDiffusion's consistent
self-attention) and, in 8-channel mel form with the CLAP class embedding, of
AudioLDM.

``forward`` takes and returns NHWC latents, as the JAX module does; inside,
the convolutions run in NCHW. Submodule names follow the JAX parameter tree
(``down_0_res_0``, ``up_3_attn_2.block_0.attn1.to_q``, ...).

Numerics held to the reference: the transformer-block LayerNorms use Flax's
default eps=1e-6; GroupNorm eps is 1e-5 in the resnets and 1e-6 in
Transformer2D; the GEGLU feed-forward uses the tanh form of GELU, which is
jax.nn.gelu's default.

Consistent self-attention (StoryDiffusion, the SDXL story path): a
self-attention block may take extra keys and values (``story_kv``, by block
path) or sample them from the first ``id_length`` rows of each consistency
group (``story``, on the up blocks). A bank shared by a group runs as two
partial attentions, over the row's own keys and over the bank, merged
exactly through their logsumexps (``_attention_lse``); ``story_bank_config``
picks that form ("split"), one attention over the bank broadcast to every
row ("concat") or the ablation without the bank ("self_only").
"""

from __future__ import annotations

import contextlib
import dataclasses
from contextvars import ContextVar
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from spider_tpu_torch.models.schedulers import timestep_embedding
from spider_tpu_torch.ops.attention import flash_attention, flash_attention_with_lse


@dataclasses.dataclass(frozen=True)
class UNet2DConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    cross_attn_blocks: Tuple[bool, ...] = (True, True, True, False)
    layers_per_block: int = 2
    transformer_layers_per_block: Tuple[int, ...] = (1, 1, 1, 1)
    num_attention_heads: Tuple[int, ...] = (8, 8, 8, 8)
    cross_attention_dim: int = 768
    norm_num_groups: int = 32
    addition_embed_type: Optional[str] = None    # "text_time" (SDXL), "class_embed" (AudioLDM)
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816   # SDXL
    dtype: torch.dtype = torch.float32


def unet_sd15() -> UNet2DConfig:
    return UNet2DConfig()


def unet_sdxl() -> UNet2DConfig:
    return UNet2DConfig(block_out_channels=(320, 640, 1280),
                        cross_attn_blocks=(False, True, True),
                        transformer_layers_per_block=(0, 2, 10),
                        num_attention_heads=(5, 10, 20), cross_attention_dim=2048,
                        addition_embed_type="text_time")


def unet_audioldm() -> UNet2DConfig:
    """AudioLDM-l: 8 latent channels; the CLAP embedding enters through the
    class embedding (pipelines/ad.py sets addition_embed_type and the CLAP
    widths)."""
    return UNet2DConfig(in_channels=8, out_channels=8, block_out_channels=(128, 256, 384, 640),
                        cross_attn_blocks=(True, True, True, True),
                        num_attention_heads=(8, 8, 8, 8), cross_attention_dim=128)


def unet_tiny(cross_attention_dim: int = 32, addition_embed_type: Optional[str] = None,
              projection_dim: int = 40, in_channels: int = 4,
              out_channels: int = 4) -> UNet2DConfig:
    return UNet2DConfig(in_channels=in_channels, out_channels=out_channels,
                        block_out_channels=(16, 32), cross_attn_blocks=(True, True),
                        layers_per_block=1, transformer_layers_per_block=(1, 1),
                        num_attention_heads=(2, 2), cross_attention_dim=cross_attention_dim,
                        norm_num_groups=4, addition_embed_type=addition_embed_type,
                        addition_time_embed_dim=8,
                        projection_class_embeddings_input_dim=projection_dim)


# Spatial-attention routing override for A/B checks: "auto" = the
# predicate below; "einsum" = plain attention everywhere.
_SPATIAL_FLASH = ContextVar("spatial_flash", default="auto")


@contextlib.contextmanager
def spatial_flash_config(mode: str):
    if mode not in ("auto", "einsum"):
        raise ValueError(mode)
    tok = _SPATIAL_FLASH.set(mode)
    try:
        yield
    finally:
        _SPATIAL_FLASH.reset(tok)


# The wgmma forward's work item is (128 query rows, head, batch), one
# persistent block an SM. With fewer items than this, over more keys than
# FLASH_FEW_ITEMS_MAX_KEYS, a few SMs walk every key alone (SAM's
# token-to-image at batch 1: 8 items over 4096 keys).
FLASH_MIN_ITEMS = 16
FLASH_FEW_ITEMS_MAX_KEYS = 1024


def spatial_flash_predicate(B: int, T: int, S: int, heads: int, D: int) -> bool:
    """Where spatial attention goes to the flash kernel on the card: every
    head dim the kernel takes, D <= 128, except a call with fewer than
    FLASH_MIN_ITEMS work items (B x heads x ceil(T / 128)) over more than
    FLASH_FEW_ITEMS_MAX_KEYS keys, which stays on the einsum. Every UNet
    shape has at least 16 items and goes to the kernel.

    The reference's rule for its TPU kernel (unet2d.py:163-165: T >= 4096 or,
    for D >= 64, fp32 logits over 512 MiB) kept the plain einsum at every
    level but the first of SD-1.5 and AudioLDM and at all of ZeroScope. On an
    H100 the rows of ``chip_smoke.py``'s phase ``unet_routing`` (flash against
    this module's einsum, device time in ms, bf16, CFG batch 2, ZeroScope's 16
    frames in the batch; NVIDIA H100 80GB HBM3, 700 W) put the kernel ahead at
    every UNet shape it takes, self- and cross-attention alike, down to
    T = 128, and at the grounding shapes but one, which the rule's exception
    keeps on the einsum:

      SD-1.5 512px     L0 T 4096 D 40: self 0.178 / 3.41, cross (S 77) 0.018 / 0.115
                       L1 T 1024 D 80: self 0.020 / 0.261, cross 0.010 / 0.057
      AudioLDM 5 s     L0 T 8192 D 16: self 0.596 / 14.3, cross (S 1) 0.015 / 0.041
                       L1 T 2048 D 32: self 0.045 / 0.857, cross 0.007 / 0.031
                       L2 T 512 D 48: self 0.010 / 0.072, cross 0.005 / 0.025
                       L3, mid T 128 D 80: self 0.007 / 0.034, cross 0.006 / 0.024
      ZeroScope 576x320x16  L0 T 2880 D 40 (B 32): self 1.39 / 27.7, cross 0.156 / 1.13
                       L1 T 720 D 80: self 0.165 / 1.88, cross 0.059 / 0.389
      SDXL story 768px (B 8: 4 frames, batched CFG; chip_smoke.py story, same card)
                       L1 T 2304 D 64: self 0.289 / 5.92, cross 0.048 / 0.349
                       L2, mid T 576 D 64: self 0.069 / 0.766, cross 0.030 / 0.183
      Grounding DINO 512px (B 1, 8 heads; chip_smoke.py grounding, same card)
                       decoder self T 900 D 32: 0.0155 / 0.104 (SDPA 0.0157)
      SAM ViT-H mask decoder, 8 heads, the 64 x 64 grid (S or T 4096)
                       box prompt, B 1: self T 7 D 32 0.0043 / 0.0193,
                       image-to-token T 4096 S 7 D 16 0.0063 / 0.0274,
                       token-to-image T 7 S 4096 D 16 0.0433 / 0.0281 (8 items:
                       the einsum's)
                       MASK train step, B 4: self T 6 0.0043 / 0.0286,
                       image-to-token 0.0150 / 0.0551, token-to-image T 6
                       0.0450 / 0.0636 (32 items)

    As single calls with the host's time in them, the large shapes rank the
    same way and the small ones are host-bound on either side (0.07-0.2 ms
    for the one-launch wrapper, 0.15-0.47 ms for the einsum's eight launches).
    SD-1.5's and ZeroScope's levels 2 and mid have D = 160, which no flash
    kernel here takes: they stay on the einsum (T <= 256, 0.04-0.29 ms)."""
    items = B * heads * -(-T // 128)
    return D <= 128 and not (items < FLASH_MIN_ITEMS and S > FLASH_FEW_ITEMS_MAX_KEYS)


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    heads: int) -> torch.Tensor:
    """Softmax attention on [B, T, C] projections: the reference's einsum
    with an fp32 softmax. The aligners and ImageBind call it directly: their
    attention (T <= 257, fp32 in the aligners) is no UNet's and stays off the
    flash kernel."""
    B, T, C = q.shape
    S = k.shape[1]
    D = C // heads
    q = q.reshape(B, T, heads, D).transpose(1, 2)
    k = k.reshape(B, S, heads, D).transpose(1, 2)
    v = v.reshape(B, S, heads, D).transpose(1, 2)
    logits = torch.einsum("bhtd,bhsd->bhts", q, k).float() / (D ** 0.5)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhts,bhsd->bhtd", probs, v)
    return out.transpose(1, 2).reshape(B, T, C)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """The UNets' spatial attention on [B, T, C] projections.

    Routed to the flash kernel on CUDA tensors where
    ``spatial_flash_predicate`` holds: at SD-1.5 512px and ZeroScope levels 0
    and 1 (D = 40, 80), at AudioLDM every level (D = 16 to 80; S = 1 in
    cross-attention), self- and cross-attention; Grounding DINO's decoder
    self-attention and SAM's mask decoder, but for its token-to-image
    attention at batch 1. The kernel masks the ragged
    edges and takes those head dims itself, so none of the reference's
    padding is needed. Elsewhere (D = 160, CPU tensors, the "einsum"
    override): ``plain_attention``.
    """
    B, T, C = q.shape
    S = k.shape[1]
    D = C // heads
    use_flash = (_SPATIAL_FLASH.get() == "auto" and q.is_cuda
                 and spatial_flash_predicate(B, T, S, heads, D))
    if use_flash:
        out = flash_attention(q.reshape(B, T, heads, D), k.reshape(B, S, heads, D),
                              v.reshape(B, S, heads, D), causal=False,
                              sm_scale=1.0 / (D ** 0.5))
        return out.reshape(B, T, C)
    return plain_attention(q, k, v, heads)


def _attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int):
    """``_attention`` that also returns the logsumexp of each row's scaled
    logits, lse [B, heads, T] fp32, so that two partial attentions over
    disjoint key sets merge exactly (the story bank).

    On CUDA tensors it calls ``flash_attention_with_lse`` where
    ``spatial_flash_predicate`` holds, as ``_attention`` routes; the kernel
    masks the ragged edges itself, so none of the reference's padding is
    needed. Elsewhere (CPU tensors, the "einsum" override): the reference's
    plain form, fp32 logits with m + log(l)."""
    B, T, C = q.shape
    S = k.shape[1]
    D = C // heads
    use_flash = (_SPATIAL_FLASH.get() == "auto" and q.is_cuda
                 and spatial_flash_predicate(B, T, S, heads, D))
    if use_flash:
        out, lse = flash_attention_with_lse(
            q.reshape(B, T, heads, D), k.reshape(B, S, heads, D), v.reshape(B, S, heads, D),
            causal=False, sm_scale=1.0 / (D ** 0.5))
        return out.reshape(B, T, C), lse
    qt = q.reshape(B, T, heads, D).transpose(1, 2)
    kt = k.reshape(B, S, heads, D).transpose(1, 2)
    vt = v.reshape(B, S, heads, D).transpose(1, 2)
    logits = torch.einsum("bhtd,bhsd->bhts", qt, kt).float() / (D ** 0.5)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhts,bhsd->bhtd", (p / l).to(vt.dtype), vt)
    return out.transpose(1, 2).reshape(B, T, C), (m + torch.log(l))[..., 0]


# The story bank's form: "split" runs self and bank attention separately and
# merges them by logsumexp; "concat" broadcasts the group's bank to every row
# and runs one attention over the concatenated keys; "self_only" drops the
# bank (an ablation). The bank call routes as every other call does, by
# spatial_flash_predicate. At the story point (SDXL 768px, 4 frames,
# id_length 4, batched CFG) the kernel takes the up_1 bank, [2, 9216]
# queries over 4608 keys, in 0.555 ms of device time against 18.1 ms for the
# plain form, and the up_0 bank ([2, 2304] over 1152) in 0.089 against 2.40
# (chip_smoke.py's unet_routing bank rows; NVIDIA H100 80GB HBM3, 700 W).
# A ContextVar, so an override stays inside its scope and its thread.
BANK_IMPLS = ("split", "concat", "self_only")
_STORY_BANK_IMPL = ContextVar("story_bank_impl", default="split")


@contextlib.contextmanager
def story_bank_config(impl: str):
    """Scoped override of the story bank attention (split | concat |
    self_only)."""
    if impl not in BANK_IMPLS:
        raise ValueError(f"impl must be one of {BANK_IMPLS}, got {impl!r}")
    tok = _STORY_BANK_IMPL.set(impl)
    try:
        yield
    finally:
        _STORY_BANK_IMPL.reset(tok)


def _bank_attention(q, k, v, ek, ev, heads: int) -> torch.Tensor:
    """Self-attention of B rows over their own keys and a bank shared by
    each of g groups of B // g consecutive rows: q, k, v [B, T, C]; ek, ev
    [g, K, C]. The softmax runs over the union of both key sets."""
    g, K, C = ek.shape
    B, T, _ = q.shape
    rows, D = B // g, C // heads
    impl = _STORY_BANK_IMPL.get()
    if impl == "self_only":
        return _attention(q, k, v, heads)
    if impl == "concat":
        ekb = ek[:, None].expand(g, rows, K, C).reshape(B, K, C)
        evb = ev[:, None].expand(g, rows, K, C).reshape(B, K, C)
        return _attention(q, torch.cat([ekb, k], dim=1), torch.cat([evb, v], dim=1), heads)
    # split: the bank side folds each group's rows into one call
    # ([g, rows * T] queries over [g, K] keys), so the bank stays at group size.
    o_self, l_self = _attention_lse(q, k, v, heads)
    o_bank, l_bank = _attention_lse(q.reshape(g, rows * T, C), ek, ev, heads)
    l_bank = l_bank.reshape(g, heads, rows, T).transpose(1, 2).reshape(B, heads, T)
    l_tot = torch.logaddexp(l_self, l_bank)
    w_self = torch.exp(l_self - l_tot).transpose(1, 2)[..., None]      # [B, T, heads, 1]
    w_bank = torch.exp(l_bank - l_tot).transpose(1, 2)[..., None]
    out = (o_self.reshape(B, T, heads, D).float() * w_self
           + o_bank.reshape(B, T, heads, D).float() * w_bank)
    return out.reshape(B, T, C).to(o_self.dtype)


class ResnetBlock2D(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int, temb_dim: int, dt, device=None):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=1e-5, dtype=dt, device=device)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1, dtype=dt, device=device)
        self.time_emb_proj = nn.Linear(temb_dim, cout, dtype=dt, device=device)
        self.norm2 = nn.GroupNorm(groups, cout, eps=1e-5, dtype=dt, device=device)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1, dtype=dt, device=device)
        self.conv_shortcut = (nn.Conv2d(cin, cout, 1, dtype=dt, device=device)
                              if cin != cout else None)

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class CrossAttention(nn.Module):
    def __init__(self, ch: int, ctx_dim: int, heads: int, dt, device=None):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(ch, ch, bias=False, dtype=dt, device=device)
        self.to_k = nn.Linear(ctx_dim, ch, bias=False, dtype=dt, device=device)
        self.to_v = nn.Linear(ctx_dim, ch, bias=False, dtype=dt, device=device)
        self.to_out = nn.Linear(ch, ch, dtype=dt, device=device)

    def forward(self, x, context=None, extra_kv=None):
        """extra_kv [B or g, K, C]: extra keys and values for self-attention,
        projected by to_k and to_v. With the batch's own leading dim they go
        in front of each row's keys; with a smaller one (g groups) each group
        of B // g rows shares them (``_bank_attention``)."""
        ctx = x if context is None else context
        q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
        if extra_kv is None:
            return self.to_out(_attention(q, k, v, self.heads))
        ek, ev = self.to_k(extra_kv), self.to_v(extra_kv)
        if ek.shape[0] != k.shape[0]:
            return self.to_out(_bank_attention(q, k, v, ek, ev, self.heads))
        return self.to_out(_attention(q, torch.cat([ek, k], dim=1), torch.cat([ev, v], dim=1),
                                      self.heads))


class FeedForward(nn.Module):
    def __init__(self, ch: int, dt, device=None):
        super().__init__()
        self.proj_in = nn.Linear(ch, ch * 8, dtype=dt, device=device)
        self.proj_out = nn.Linear(ch * 4, ch, dtype=dt, device=device)

    def forward(self, x):
        a, b = self.proj_in(x).chunk(2, dim=-1)
        return self.proj_out(a * F.gelu(b, approximate="tanh"))


class BasicTransformerBlock(nn.Module):
    def __init__(self, ch: int, ctx_dim: int, heads: int, dt, device=None):
        super().__init__()
        self.norm1 = nn.LayerNorm(ch, eps=1e-6, dtype=dt, device=device)
        self.attn1 = CrossAttention(ch, ch, heads, dt, device)
        self.norm2 = nn.LayerNorm(ch, eps=1e-6, dtype=dt, device=device)
        self.attn2 = CrossAttention(ch, ctx_dim, heads, dt, device)
        self.norm3 = nn.LayerNorm(ch, eps=1e-6, dtype=dt, device=device)
        self.ff = FeedForward(ch, dt, device)

    def forward(self, x, context, story_kv=None, story=None):
        """story: dict(id_length, indices [K] int64, num_groups) activating
        consistent self-attention: each of num_groups groups of rows takes as
        extra keys the K tokens `indices` picks from its first id_length rows'
        self-attention inputs (StoryDiffusion's consistent self-attention)."""
        h = self.norm1(x)
        extra = story_kv
        if story is not None:
            idl, groups = story["id_length"], story.get("num_groups", 1)
            BT, T, C = h.shape
            bank = h.reshape(groups, BT // groups, T, C)[:, :idl].reshape(groups, idl * T, C)
            extra = bank.index_select(1, story["indices"])
        x = x + self.attn1(h, extra_kv=extra)
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    def __init__(self, ch: int, ctx_dim: int, heads: int, depth: int, groups: int, dt,
                 device=None):
        super().__init__()
        self.depth = depth
        self.norm = nn.GroupNorm(groups, ch, eps=1e-6, dtype=dt, device=device)
        self.proj_in = nn.Linear(ch, ch, dtype=dt, device=device)
        for i in range(depth):
            self.add_module(f"block_{i}", BasicTransformerBlock(ch, ctx_dim, heads, dt,
                                                                device))
        self.proj_out = nn.Linear(ch, ch, dtype=dt, device=device)

    def forward(self, x, context, story_kv=None, story=None):
        B, C, H, W = x.shape
        h = self.norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        h = self.proj_in(h)
        for i in range(self.depth):
            h = getattr(self, f"block_{i}")(h, context, story_kv, story)
        h = self.proj_out(h)
        return h.reshape(B, H, W, C).permute(0, 3, 1, 2) + x


class UNet2DConditionModel(nn.Module):
    def __init__(self, cfg: UNet2DConfig, device=None):
        super().__init__()
        self.config = cfg
        dt, g = cfg.dtype, cfg.norm_num_groups
        chs = cfg.block_out_channels
        ctx = cfg.cross_attention_dim
        tdim = chs[0] * 4
        self.time_embed_1 = nn.Linear(chs[0], tdim, dtype=dt, device=device)
        self.time_embed_2 = nn.Linear(tdim, tdim, dtype=dt, device=device)
        if cfg.addition_embed_type not in (None, "text_time", "class_embed"):
            raise NotImplementedError(f"addition_embed_type={cfg.addition_embed_type!r}")
        if cfg.addition_embed_type == "text_time":
            self.add_embed_1 = nn.Linear(cfg.projection_class_embeddings_input_dim, tdim,
                                         dtype=dt, device=device)
            self.add_embed_2 = nn.Linear(tdim, tdim, dtype=dt, device=device)
        if cfg.addition_embed_type == "class_embed":
            self.class_embed_1 = nn.Linear(cfg.projection_class_embeddings_input_dim, tdim,
                                           dtype=dt, device=device)
            self.class_embed_2 = nn.Linear(tdim, tdim, dtype=dt, device=device)
        self.conv_in = nn.Conv2d(cfg.in_channels, chs[0], 3, padding=1, dtype=dt,
                                 device=device)
        cur = chs[0]
        skips = [cur]
        for i, ch in enumerate(chs):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{i}_res_{j}", ResnetBlock2D(cur, ch, g, tdim, dt, device))
                cur = ch
                if self._has_attn_down(i):
                    self.add_module(f"down_{i}_attn_{j}", Transformer2D(
                        ch, ctx, cfg.num_attention_heads[i],
                        cfg.transformer_layers_per_block[i], g, dt, device))
                skips.append(ch)
            if i < len(chs) - 1:
                self.add_module(f"down_{i}_downsample", nn.Conv2d(
                    ch, ch, 3, stride=2, padding=1, dtype=dt, device=device))
                skips.append(ch)
        self.mid_res_0 = ResnetBlock2D(cur, cur, g, tdim, dt, device)
        self.mid_attn = (Transformer2D(cur, ctx, cfg.num_attention_heads[-1],
                                       max(cfg.transformer_layers_per_block[-1], 1), g, dt,
                                       device)
                         if cfg.cross_attn_blocks[-1] or cfg.addition_embed_type == "text_time"
                         else None)
        self.mid_res_1 = ResnetBlock2D(cur, cur, g, tdim, dt, device)
        n = len(chs)
        for i, ch in enumerate(reversed(chs)):
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{i}_res_{j}",
                                ResnetBlock2D(cur + skips.pop(), ch, g, tdim, dt, device))
                cur = ch
                if self._has_attn_up(i):
                    self.add_module(f"up_{i}_attn_{j}", Transformer2D(
                        ch, ctx, cfg.num_attention_heads[n - 1 - i],
                        cfg.transformer_layers_per_block[n - 1 - i], g, dt, device))
            if i < n - 1:
                self.add_module(f"up_{i}_upsample", nn.Conv2d(ch, ch, 3, padding=1, dtype=dt,
                                                              device=device))
        self.norm_out = nn.GroupNorm(g, cur, eps=1e-5, dtype=dt, device=device)
        self.conv_out = nn.Conv2d(cur, cfg.out_channels, 3, padding=1, dtype=dt,
                                  device=device)

    def _has_attn_down(self, i: int) -> bool:
        cfg = self.config
        return cfg.cross_attn_blocks[i] and cfg.transformer_layers_per_block[i] > 0

    def _has_attn_up(self, i: int) -> bool:
        return self._has_attn_down(len(self.config.block_out_channels) - 1 - i)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                added_cond: Optional[Dict[str, torch.Tensor]] = None,
                story_kv: Optional[Dict[str, torch.Tensor]] = None,
                story: Optional[Dict[str, Dict]] = None) -> torch.Tensor:
        """sample [B,H,W,Cin] NHWC; timesteps [B]; encoder_hidden_states
        [B,S,Dctx]; added_cond {"text_embeds": [B, pooled], "time_ids": [B, 6]}
        for text_time (SDXL), {"class_embeds": [B, Dcls]} for class_embed
        -> [B,H,W,Cout] in the model's dtype.

        story_kv: {block path: [B or g, K, C]} extra self-attention keys for
        any transformer block (``down_1_attn_0``, ``mid_attn``, ...).
        story: {up block path: dict(id_length, indices, num_groups)}
        activating consistent self-attention in those up blocks."""
        cfg = self.config
        dt = cfg.dtype
        n = len(cfg.block_out_channels)
        temb = timestep_embedding(timesteps, cfg.block_out_channels[0]).to(dt)
        temb = self.time_embed_2(F.silu(self.time_embed_1(temb)))
        if cfg.addition_embed_type == "text_time":
            if added_cond is None:
                raise ValueError("the text_time UNet needs added_cond['text_embeds', 'time_ids']")
            text_embeds = added_cond["text_embeds"]
            tid = timestep_embedding(added_cond["time_ids"].reshape(-1),
                                     cfg.addition_time_embed_dim)
            add = torch.cat([text_embeds.float(), tid.reshape(text_embeds.shape[0], -1)],
                            dim=-1).to(dt)
            temb = temb + self.add_embed_2(F.silu(self.add_embed_1(add)))
        elif cfg.addition_embed_type == "class_embed":
            # AudioLDM: the CLAP embedding projected into the time embedding.
            if added_cond is None:
                raise ValueError("the class_embed UNet needs added_cond['class_embeds']")
            cls = added_cond["class_embeds"].to(dt)
            temb = temb + self.class_embed_2(F.silu(self.class_embed_1(cls)))
        ctx = encoder_hidden_states.to(dt)
        story_kv, story = story_kv or {}, story or {}
        x = self.conv_in(sample.to(dt).permute(0, 3, 1, 2).contiguous())
        skips = [x]
        for i in range(n):
            for j in range(cfg.layers_per_block):
                x = getattr(self, f"down_{i}_res_{j}")(x, temb)
                if self._has_attn_down(i):
                    path = f"down_{i}_attn_{j}"
                    x = getattr(self, path)(x, ctx, story_kv.get(path))
                skips.append(x)
            if i < n - 1:
                x = getattr(self, f"down_{i}_downsample")(x)
                skips.append(x)
        x = self.mid_res_0(x, temb)
        if self.mid_attn is not None:
            x = self.mid_attn(x, ctx, story_kv.get("mid_attn"))
        x = self.mid_res_1(x, temb)
        for i in range(n):
            for j in range(cfg.layers_per_block + 1):
                x = getattr(self, f"up_{i}_res_{j}")(torch.cat([x, skips.pop()], dim=1), temb)
                if self._has_attn_up(i):
                    path = f"up_{i}_attn_{j}"
                    x = getattr(self, path)(x, ctx, story_kv.get(path), story.get(path))
            if i < n - 1:
                x = getattr(self, f"up_{i}_upsample")(F.interpolate(x, scale_factor=2,
                                                                    mode="nearest"))
        x = self.conv_out(F.silu(self.norm_out(x)))
        return x.permute(0, 2, 3, 1).contiguous()
