"""SDXL base 1.0 with StoryDiffusion's consistent self-attention, plain fp32.

The layer equations are those the measured program computes
(models/unet2d.py, models/clip_text.py, models/schedulers.py and
models/pipelines/sdxl_story.py of the port), written here again with plain
attention and no kernel:

- two CLIP text encoders on the same tokens: the conditioning is the
  penultimate layer's states of both, concatenated (768 + 1280 = 2048); the
  pooled vector is the second encoder's final-normed state at the first EOS
  token through its text projection;
- the UNet's ``text_time`` embedding: the pooled vector and the six size ids
  (each through the sinusoidal embedding), into the time embedding;
- transformer stacks of depth 2 and 10 (GroupNorm eps 1e-6, linear
  projections in and out, LayerNorm eps 1e-6, GEGLU with the tanh GELU);
- consistent self-attention in the up blocks: each row of a consistency
  group attends, in one softmax, over the union of its own tokens and the
  group's bank, the tokens ``indices`` picks from the group's first
  ``id_length`` rows' normed inputs of that block;
- the Euler step over the scaled-linear schedule's sigmas ("leading"
  timesteps, offset 1), in fp64 as ``ddim.py`` does;
- the VAE decode of ``vae.py`` with SDXL's scaling factor.

Parameter names are those of the weights the benchmark fills. The
configuration's ``departures`` lists where these equations depart from the
published models.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import tokenizer
from benchmark.reference.clip_text import CLIPText
from benchmark.reference.layers import Conv, Lin, attention
from benchmark.reference.unet import Block, Resnet, timestep_embedding
from benchmark.reference.vae import VAEDecode

# ------------------------------------------------------------------- text


def token_ids(prompt: str, length: int, eos: int) -> List[int]:
    """The byte-level ids of ``tokenizer.token_ids`` with the encoder's own
    EOS id closing and padding (the pipeline closes and pads with it)."""
    return [eos if i == tokenizer.EOS else i for i in tokenizer.token_ids(prompt, length)]


class CLIPTextXL(CLIPText):
    """forward(ids [B, T]) -> (the penultimate layer's states [B, T, H], the
    projected pooled vector [B, P], or None without a projection)."""

    def __init__(self, cfg: dict):
        super().__init__(cfg)
        self.eos = cfg["eos_token_id"]
        proj = cfg.get("projection_dim")
        self.text_projection = Lin(cfg["hidden_size"], proj, bias=False) if proj else None

    def forward(self, ids):
        x = self.token_embedding(ids) + self.position_embedding[None, :ids.shape[1]]
        for i in range(self.n):
            penultimate = x                   # the last layer's input
            x = getattr(self, f"layers_{i}")(x)
        if self.text_projection is None:
            return penultimate, None
        first_eos = (ids == self.eos).int().argmax(dim=-1)
        rows = torch.arange(ids.shape[0], device=ids.device)
        return penultimate, self.text_projection(self.final_layer_norm(x)[rows, first_eos])


# ------------------------------------------------------------------- UNet


def consistent_attention(attn, h: torch.Tensor, story: dict) -> torch.Tensor:
    """Self-attention of h [B, T, C] in ``num_groups`` groups of consecutive
    rows, each row over its own tokens and its group's bank in one softmax
    (keys concatenated). The bank is projected once a group, then given to
    each of its rows."""
    g, idl, idx = story["num_groups"], story["id_length"], story["indices"]
    B, T, C = h.shape
    rows = B // g
    bank = h.reshape(g, rows, T, C)[:, :idl].reshape(g, idl * T, C)[:, idx]

    def union(proj):
        return torch.cat([proj(bank).repeat_interleave(rows, dim=0), proj(h)], dim=1)

    return attn.to_out(attention(attn.to_q(h), union(attn.to_k), union(attn.to_v), attn.heads))


class StoryBlock(Block):
    def forward(self, x, context, story: Optional[dict] = None):
        h = self.norm1(x)
        x = x + (self.attn1(h) if story is None else consistent_attention(self.attn1, h, story))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2DXL(nn.Module):
    def __init__(self, ch, ctx, heads, depth, groups):
        super().__init__()
        self.depth = depth
        self.norm = nn.GroupNorm(groups, ch, eps=1e-6)
        self.proj_in = Lin(ch, ch)
        for i in range(depth):
            self.add_module(f"block_{i}", StoryBlock(ch, ctx, heads))
        self.proj_out = Lin(ch, ch)

    def forward(self, x, context, story=None):
        B, C, H, W = x.shape
        h = self.proj_in(self.norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C))
        for i in range(self.depth):
            h = getattr(self, f"block_{i}")(h, context, story)
        h = self.proj_out(h)
        return x + h.reshape(B, H, W, C).permute(0, 3, 1, 2)


class SDXLUNet(nn.Module):
    """forward(sample [B, H, W, 4], timesteps [B], context [B, S, 2048],
    text_embeds [B, 1280], time_ids [B, 6], story) -> eps [B, H, W, 4].
    ``story``: {up block path: dict(id_length, indices, num_groups)}.
    ``cfg`` is the configuration file's "unet_as_run"."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        chs, L = cfg["block_out_channels"], cfg["layers_per_block"]
        heads, depth = cfg["num_attention_heads"], cfg["transformer_layers_per_block"]
        g, ctx = cfg["norm_num_groups"], cfg["cross_attention_dim"]
        n = len(chs)
        tdim = chs[0] * 4
        self.time_embed_1 = Lin(chs[0], tdim)
        self.time_embed_2 = Lin(tdim, tdim)
        self.add_embed_1 = Lin(cfg["projection_class_embeddings_input_dim"], tdim)
        self.add_embed_2 = Lin(tdim, tdim)
        self.conv_in = Conv(cfg["in_channels"], chs[0], 3, padding=1)
        cur, skips = chs[0], [chs[0]]
        for i, ch in enumerate(chs):
            for j in range(L):
                self.add_module(f"down_{i}_res_{j}", Resnet(cur, ch, g, tdim))
                cur = ch
                if self.has_attn(i):
                    self.add_module(f"down_{i}_attn_{j}",
                                    Transformer2DXL(ch, ctx, heads[i], depth[i], g))
                skips.append(ch)
            if i < n - 1:
                self.add_module(f"down_{i}_downsample", Conv(ch, ch, 3, stride=2, padding=1))
                skips.append(ch)
        self.mid_res_0 = Resnet(cur, cur, g, tdim)
        self.mid_attn = Transformer2DXL(cur, ctx, heads[-1], depth[-1], g)
        self.mid_res_1 = Resnet(cur, cur, g, tdim)
        for i, ch in enumerate(reversed(chs)):
            for j in range(L + 1):
                self.add_module(f"up_{i}_res_{j}", Resnet(cur + skips.pop(), ch, g, tdim))
                cur = ch
                if self.has_attn(n - 1 - i):
                    self.add_module(f"up_{i}_attn_{j}", Transformer2DXL(
                        ch, ctx, heads[n - 1 - i], depth[n - 1 - i], g))
            if i < n - 1:
                self.add_module(f"up_{i}_upsample", Conv(ch, ch, 3, padding=1))
        self.norm_out = nn.GroupNorm(g, cur, eps=1e-5)
        self.conv_out = Conv(cur, cfg["out_channels"], 3, padding=1)

    def has_attn(self, level: int) -> bool:
        cfg = self.cfg
        return cfg["cross_attn_blocks"][level] and cfg["transformer_layers_per_block"][level] > 0

    def forward(self, sample, timesteps, context, text_embeds, time_ids, story=None):
        cfg = self.cfg
        chs, L = cfg["block_out_channels"], cfg["layers_per_block"]
        n = len(chs)
        story = story or {}
        temb = self.time_embed_2(F.silu(self.time_embed_1(timestep_embedding(timesteps, chs[0]))))
        tid = timestep_embedding(time_ids.reshape(-1), cfg["addition_time_embed_dim"])
        add = torch.cat([text_embeds, tid.reshape(text_embeds.shape[0], -1)], dim=-1)
        temb = temb + self.add_embed_2(F.silu(self.add_embed_1(add)))
        x = self.conv_in(sample.permute(0, 3, 1, 2))
        skips = [x]
        for i in range(n):
            for j in range(L):
                x = getattr(self, f"down_{i}_res_{j}")(x, temb)
                if self.has_attn(i):
                    x = getattr(self, f"down_{i}_attn_{j}")(x, context)
                skips.append(x)
            if i < n - 1:
                x = getattr(self, f"down_{i}_downsample")(x)
                skips.append(x)
        x = self.mid_res_1(self.mid_attn(self.mid_res_0(x, temb), context), temb)
        for i in range(n):
            for j in range(L + 1):
                x = getattr(self, f"up_{i}_res_{j}")(torch.cat([x, skips.pop()], dim=1), temb)
                if self.has_attn(n - 1 - i):
                    path = f"up_{i}_attn_{j}"
                    x = getattr(self, path)(x, context, story.get(path))
            if i < n - 1:
                x = getattr(self, f"up_{i}_upsample")(F.interpolate(x, scale_factor=2,
                                                                    mode="nearest"))
        return self.conv_out(F.silu(self.norm_out(x))).permute(0, 2, 3, 1)


# ------------------------------------------------------------------ Euler


def euler_schedule(sched: dict, steps: int) -> Tuple[List[float], List[int]]:
    """(sigmas [steps + 1] ending in 0, timesteps [steps]) in fp64: sigma(t)
    = sqrt((1 - alpha_bar(t)) / alpha_bar(t)) at the "leading" timesteps."""
    betas = torch.linspace(sched["beta_start"] ** 0.5, sched["beta_end"] ** 0.5,
                           sched["num_train_timesteps"], dtype=torch.float64) ** 2
    acp = torch.cumprod(1.0 - betas, dim=0)
    stride = sched["num_train_timesteps"] // steps
    ts = [i * stride + sched["steps_offset"] for i in reversed(range(steps))]
    return [float(((1 - acp[t]) / acp[t]) ** 0.5) for t in ts] + [0.0], ts


def init_noise_sigma(sigmas: Sequence[float]) -> float:
    """The initial latents' scale over a unit normal draw ("leading")."""
    return (max(sigmas) ** 2 + 1) ** 0.5


def scale_input(latents: torch.Tensor, sigma: float) -> torch.Tensor:
    """The UNet's input at a step: the latents over sqrt(sigma^2 + 1)."""
    return latents / (sigma ** 2 + 1) ** 0.5


def guided_euler_step(latents: torch.Tensor, eps_uncond: torch.Tensor, eps_cond: torch.Tensor,
                      scale: float, sigma: float, sigma_next: float) -> torch.Tensor:
    """The latents after one Euler step of the epsilon-predicting ODE, from
    the two halves of the CFG pair's noise prediction, in fp64."""
    eps = eps_uncond.double() + scale * (eps_cond.double() - eps_uncond.double())
    return (latents.double() + (sigma_next - sigma) * eps).float()


# ----------------------------------------------------------------- models


def models(config: dict, device) -> Tuple[CLIPTextXL, CLIPTextXL, SDXLUNet, VAEDecode]:
    """(text encoder, text encoder 2, UNet, VAE decode) of `config` on
    `device`, fp32, in eval mode, weights as constructed."""
    with torch.device(device):
        return (CLIPTextXL(config["text_encoder_as_run"]).eval(),
                CLIPTextXL(config["text_encoder_2_as_run"]).eval(),
                SDXLUNet(config["unet_as_run"]).eval(),
                VAEDecode(config["vae_as_run"]).eval())


def story_of(indices: Dict[str, torch.Tensor], id_length: int, groups: int) -> Dict[str, dict]:
    """The UNet's ``story`` argument from {up block path: bank indices}."""
    return {path: dict(id_length=id_length, indices=idx, num_groups=groups)
            for path, idx in indices.items()}
