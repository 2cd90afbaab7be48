"""PhotoMaker ID encoder and the ref-image ("Using Ref Images") story mode in
PyTorch (counterpart of spider_tpu/models/photomaker.py).

PhotoMakerIDEncoder = a CLIP ViT-L/14 vision tower, two visual projections
(768 and 1280, concatenated to SDXL's 2048-d prompt-embedding width) and a
FuseModule that fuses the id embeddings into the prompt embeddings at the
class-token positions the trigger-word surgery marks
(``prompts_with_trigger``). Submodule names follow the JAX parameter tree
(``vision_model.layers_<i>.q_proj``, ``fuse_module.mlp1.fc1``, ...).

Numerics held to the reference: every LayerNorm uses Flax's default
eps=1e-6; the vision MLP uses quick GELU and the fuse MLPs the tanh form of
GELU (jax.nn.gelu's default); the class and position embeddings are held in
fp32, as the reference's params are, and cast at use. The tower's attention
(T 257, D 64 at photomaker_v1) is ``ops.attention.plain_attention``: no UNet shape,
so it stays off the flash kernel.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from spider_tpu_torch.models.clip_text import quick_gelu
from spider_tpu_torch.ops.attention import plain_attention


@dataclasses.dataclass(frozen=True)
class PhotoMakerConfig:
    # CLIP vision tower (StoryDiffusion utils/model.py VISION_CONFIG_DICT)
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    patch_size: int = 14
    image_size: int = 224
    projection_dim: int = 768          # visual_projection
    projection_dim_2: int = 1280       # visual_projection_2
    embed_dim: int = 2048              # SDXL prompt-embedding width (768 + 1280)
    dtype: torch.dtype = torch.float32


def photomaker_v1() -> PhotoMakerConfig:
    return PhotoMakerConfig()


def photomaker_tiny(embed_dim: int = 80, proj1: int = 32, proj2: int = 48) -> PhotoMakerConfig:
    return PhotoMakerConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                            num_attention_heads=4, patch_size=8, image_size=32,
                            projection_dim=proj1, projection_dim_2=proj2, embed_dim=embed_dim)


def _ln(dim: int, dt, device) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=1e-6, dtype=dt, device=device)


class _VisionBlock(nn.Module):
    def __init__(self, cfg: PhotoMakerConfig, device=None):
        super().__init__()
        C, dt = cfg.hidden_size, cfg.dtype
        self.heads = cfg.num_attention_heads
        self.layer_norm1 = _ln(C, dt, device)
        self.q_proj = nn.Linear(C, C, dtype=dt, device=device)
        self.k_proj = nn.Linear(C, C, dtype=dt, device=device)
        self.v_proj = nn.Linear(C, C, dtype=dt, device=device)
        self.out_proj = nn.Linear(C, C, dtype=dt, device=device)
        self.layer_norm2 = _ln(C, dt, device)
        self.fc1 = nn.Linear(C, cfg.intermediate_size, dtype=dt, device=device)
        self.fc2 = nn.Linear(cfg.intermediate_size, C, dtype=dt, device=device)

    def forward(self, x):
        h = self.layer_norm1(x)
        x = x + self.out_proj(plain_attention(self.q_proj(h), self.k_proj(h), self.v_proj(h),
                                              self.heads))
        return x + self.fc2(quick_gelu(self.fc1(self.layer_norm2(x))))


class CLIPVisionTower(nn.Module):
    """HF CLIPVisionModel forward: patch conv -> class token and position
    embeddings -> pre-LN -> blocks -> post-LN of the class token."""

    def __init__(self, cfg: PhotoMakerConfig, device=None):
        super().__init__()
        self.config = cfg
        C, dt = cfg.hidden_size, cfg.dtype
        n_pos = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.patch_embedding = nn.Conv2d(3, C, cfg.patch_size, stride=cfg.patch_size,
                                         bias=False, dtype=dt, device=device)
        self.class_embedding = nn.Parameter(torch.zeros(C, dtype=torch.float32, device=device))
        self.position_embedding = nn.Parameter(torch.zeros(n_pos, C, dtype=torch.float32,
                                                           device=device))
        self.pre_layrnorm = _ln(C, dt, device)
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"layers_{i}", _VisionBlock(cfg, device))
        self.post_layernorm = _ln(C, dt, device)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels [N, H, W, 3] (CLIP-normalized) -> pooled [N, hidden]."""
        cfg = self.config
        dt = cfg.dtype
        x = self.patch_embedding(pixels.to(dt).permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)                     # [N, patches, C], row-major
        N = x.shape[0]
        cls = self.class_embedding.to(dt).expand(N, 1, cfg.hidden_size)
        x = torch.cat([cls, x], dim=1) + self.position_embedding.to(dt)[None]
        x = self.pre_layrnorm(x)
        for i in range(cfg.num_hidden_layers):
            x = getattr(self, f"layers_{i}")(x)
        return self.post_layernorm(x[:, 0])


class _FuseMLP(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, hidden_dim: int, use_residual: bool, dt,
                 device=None):
        super().__init__()
        self.use_residual = use_residual
        self.layernorm = _ln(in_dim, dt, device)
        self.fc1 = nn.Linear(in_dim, hidden_dim, dtype=dt, device=device)
        self.fc2 = nn.Linear(hidden_dim, out_dim, dtype=dt, device=device)

    def forward(self, x):
        h = self.fc2(F.gelu(self.fc1(self.layernorm(x)), approximate="tanh"))
        return h + x if self.use_residual else h


class FuseModule(nn.Module):
    """fuse_fn of StoryDiffusion's utils/model.py:
    LN(MLP2(MLP1(cat(prompt, id)) + prompt))."""

    def __init__(self, embed_dim: int, dt, device=None):
        super().__init__()
        d = embed_dim
        self.mlp1 = _FuseMLP(2 * d, d, d, False, dt, device)
        self.mlp2 = _FuseMLP(d, d, d, True, dt, device)
        self.layer_norm = _ln(d, dt, device)

    def forward(self, prompt_embeds: torch.Tensor, id_embeds: torch.Tensor) -> torch.Tensor:
        """prompt_embeds, id_embeds [..., D] -> fused [..., D]."""
        x = self.mlp1(torch.cat([prompt_embeds, id_embeds], dim=-1)) + prompt_embeds
        return self.layer_norm(self.mlp2(x))


class PhotoMakerIDEncoder(nn.Module):
    def __init__(self, cfg: PhotoMakerConfig, device=None):
        super().__init__()
        self.config = cfg
        dt = cfg.dtype
        self.vision_model = CLIPVisionTower(cfg, device)
        self.visual_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False,
                                           dtype=dt, device=device)
        self.visual_projection_2 = nn.Linear(cfg.hidden_size, cfg.projection_dim_2,
                                             bias=False, dtype=dt, device=device)
        self.fuse_module = FuseModule(cfg.embed_dim, dt, device)

    def forward(self, id_pixels: torch.Tensor, prompt_embeds: torch.Tensor,
                class_mask: torch.Tensor) -> torch.Tensor:
        """id_pixels [N_id, H, W, 3]; prompt_embeds [B, 77, embed_dim];
        class_mask [B, 77] int: 0 where untouched, k > 0 meaning "fuse with id
        image k-1" (``prompts_with_trigger`` builds it)."""
        pooled = self.vision_model(id_pixels)
        id_embeds = torch.cat([self.visual_projection(pooled),
                               self.visual_projection_2(pooled)], dim=-1)   # [N_id, D]
        sel = id_embeds[(class_mask.long() - 1).clamp(min=0)]                # [B, 77, D]
        fused = self.fuse_module(prompt_embeds, sel.to(prompt_embeds.dtype))
        return torch.where((class_mask > 0)[..., None], fused, prompt_embeds)


# --------------------------------------------------------------- host helpers

def prompts_with_trigger(tokenizer, prompts: Sequence[str], trigger_word: str,
                         num_id_images: int, max_len: int, eos: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """The reference pipeline's encode_prompt_with_trigger_word surgery
    (StoryDiffusion utils/pipeline.py): remove the trigger token(s), repeat
    the class token right before it once per id image, and mark those
    positions.

    Returns (ids [B, max_len] int32, class_mask [B, max_len] int32) where
    class_mask is 0 outside fused positions and k at the position fused with
    id image k-1. A trigger word of several tokens (byte-level tokenizers)
    is matched as its whole id subsequence."""
    trig = list(tokenizer(trigger_word, add_special_tokens=False).input_ids)
    if not trig:
        raise ValueError(f"trigger word {trigger_word!r} tokenizes to nothing")
    ids_out, mask_out = [], []
    for p in prompts:
        ids = list(tokenizer(p, add_special_tokens=True).input_ids)
        clean: List[int] = []
        mask: List[int] = []
        i = 0
        while i < len(ids):
            if ids[i: i + len(trig)] == trig and clean:
                cls_tok = clean.pop()
                mask.pop()
                for k in range(num_id_images):
                    clean.append(cls_tok)
                    mask.append(k + 1)
                i += len(trig)
            else:
                clean.append(ids[i])
                mask.append(0)
                i += 1
        clean = clean[: max_len - 1] + [eos]
        mask = mask[: max_len - 1] + [0]
        clean += [eos] * (max_len - len(clean))
        mask += [0] * (max_len - len(mask))
        ids_out.append(clean)
        mask_out.append(mask)
    return np.asarray(ids_out, np.int32), np.asarray(mask_out, np.int32)


def preprocess_id_images(images: Sequence[np.ndarray], size: int) -> torch.Tensor:
    """uint8 or float HWC images -> CLIP-normalized [N, size, size, 3] fp32 on
    the CPU (nearest resize on the host; id conditioning is
    resolution-tolerant)."""
    mean = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
    std = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)
    out = []
    for im in images:
        a = np.asarray(im)
        if a.dtype == np.uint8:
            a = a.astype(np.float32) / 255.0
        ys = (np.arange(size) * a.shape[0] / size).astype(np.int32)
        xs = (np.arange(size) * a.shape[1] / size).astype(np.int32)
        a = a[ys][:, xs, :3]
        out.append((a - mean) / std)
    return torch.from_numpy(np.stack(out).astype(np.float32))


def build_tiny_photomaker(embed_dim: int = 80, *, device, seed: int = 0) -> PhotoMakerIDEncoder:
    """Random-init tiny ID encoder whose embed_dim matches build_tiny_sdxl's
    prompt-embedding width (32 + 48)."""
    from spider_tpu_torch.models.factory import random_init_

    cfg = photomaker_tiny(embed_dim=embed_dim, proj1=embed_dim - 48, proj2=48)
    gen = torch.Generator(device=device).manual_seed(seed)
    return random_init_(PhotoMakerIDEncoder(cfg, device).eval(), gen)


def build_full_photomaker(*, device, seed: int = 0,
                          dtype: torch.dtype = torch.bfloat16) -> PhotoMakerIDEncoder:
    """PhotoMaker-v1-sized ID encoder, random from `seed`; a real checkpoint's
    ``id_encoder`` state dict loads through convert.photomaker_rules."""
    from spider_tpu_torch.models.factory import random_init_

    cfg = dataclasses.replace(photomaker_v1(), dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    return random_init_(PhotoMakerIDEncoder(cfg, device).eval(), gen)
