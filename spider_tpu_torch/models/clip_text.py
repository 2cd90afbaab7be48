"""CLIP text encoder in PyTorch (counterpart of
spider_tpu/models/clip_text.py): SD-1.5 conditions on CLIP ViT-L/14 (768-d).
Submodule names follow the JAX parameter tree (``layers_<i>.q_proj``, ...).
The attention is plain torch, as the reference keeps it an XLA einsum.
Both presets use quick_gelu; the "gelu" activation of OpenCLIP bigG and the
CLAP text branch of AudioLDM are not ported yet."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from spider_tpu_torch.ops.attention import mha_reference


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    eos_token_id: int = 49407
    projection_dim: Optional[int] = None  # text_projection output (pooled)
    dtype: torch.dtype = torch.float32


def clip_vit_l14() -> CLIPTextConfig:
    return CLIPTextConfig()


def clip_tiny(vocab_size: int = 1000) -> CLIPTextConfig:
    return CLIPTextConfig(vocab_size=vocab_size, hidden_size=32, intermediate_size=64,
                          num_hidden_layers=2, num_attention_heads=4,
                          max_position_embeddings=77, projection_dim=32, eos_token_id=2)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, device=None):
        super().__init__()
        self.cfg = cfg
        H, dt = cfg.hidden_size, cfg.dtype
        self.layer_norm1 = nn.LayerNorm(H, eps=1e-5, dtype=dt, device=device)
        self.q_proj = nn.Linear(H, H, dtype=dt, device=device)
        self.k_proj = nn.Linear(H, H, dtype=dt, device=device)
        self.v_proj = nn.Linear(H, H, dtype=dt, device=device)
        self.out_proj = nn.Linear(H, H, dtype=dt, device=device)
        self.layer_norm2 = nn.LayerNorm(H, eps=1e-5, dtype=dt, device=device)
        self.fc1 = nn.Linear(H, cfg.intermediate_size, dtype=dt, device=device)
        self.fc2 = nn.Linear(cfg.intermediate_size, H, dtype=dt, device=device)

    def forward(self, x):
        cfg = self.cfg
        nh = cfg.num_attention_heads
        B, T, H = x.shape
        y = self.layer_norm1(x)
        q = self.q_proj(y).reshape(B, T, nh, H // nh)
        k = self.k_proj(y).reshape(B, T, nh, H // nh)
        v = self.v_proj(y).reshape(B, T, nh, H // nh)
        attn = mha_reference(q, k, v, causal=True)          # CLIP text is causal
        x = x + self.out_proj(attn.reshape(B, T, H))
        y = self.fc2(quick_gelu(self.fc1(self.layer_norm2(x))))
        return x + y


class CLIPTextModel(nn.Module):
    """forward(input_ids [B, T]) -> (last_hidden, all_hidden [L+1], pooled)."""

    def __init__(self, cfg: CLIPTextConfig, device=None):
        super().__init__()
        self.config = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                            dtype=cfg.dtype, device=device)
        self.position_embedding = nn.Parameter(torch.zeros(
            cfg.max_position_embeddings, cfg.hidden_size, dtype=cfg.dtype, device=device))
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"layers_{i}", CLIPEncoderLayer(cfg, device))
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=1e-5, dtype=cfg.dtype,
                                             device=device)
        self.text_projection = (nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False,
                                          dtype=cfg.dtype, device=device)
                                if cfg.projection_dim else None)

    def forward(self, input_ids: torch.Tensor):
        cfg = self.config
        T = input_ids.shape[1]
        x = self.token_embedding(input_ids) + self.position_embedding[None, :T]
        hiddens = [x]
        for i in range(cfg.num_hidden_layers):
            x = getattr(self, f"layers_{i}")(x)
            hiddens.append(x)
        x = self.final_layer_norm(x)
        # Pooled: the state at each sequence's first EOS token (HF convention).
        eos_pos = (input_ids == cfg.eos_token_id).int().argmax(dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eos_pos]
        if self.text_projection is not None:
            pooled = self.text_projection(pooled)
        return x, torch.stack(hiddens, dim=0), pooled
