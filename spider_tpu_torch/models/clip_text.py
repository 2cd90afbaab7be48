"""CLIP-family text encoders in PyTorch (counterpart of
spider_tpu/models/clip_text.py): SD-1.5 conditions on CLIP ViT-L/14 (768-d),
ZeroScope on CLIP ViT-H (1024-d), SDXL on CLIP-L and OpenCLIP bigG (1280-d,
penultimate layer and the projected pooled output), AudioLDM on the CLAP text branch (512-d
pooled projection). Submodule names follow the JAX parameter tree
(``layers_<i>.q_proj``, ``l<i>_q``, ...). The attention is plain torch, as
the reference keeps it an XLA einsum. "gelu" is the tanh form, which is
jax.nn.gelu's default."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
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
    hidden_act: str = "quick_gelu"        # or "gelu" (tanh form)
    eos_token_id: int = 49407
    projection_dim: Optional[int] = None  # text_projection output (pooled)
    dtype: torch.dtype = torch.float32


def clip_vit_l14() -> CLIPTextConfig:
    return CLIPTextConfig()


def clip_vit_h14() -> CLIPTextConfig:
    return CLIPTextConfig(hidden_size=1024, intermediate_size=4096, num_hidden_layers=23,
                          num_attention_heads=16)


def open_clip_bigg() -> CLIPTextConfig:
    """SDXL's second text encoder: tanh GELU and a 1280-d text_projection."""
    return CLIPTextConfig(hidden_size=1280, intermediate_size=5120, num_hidden_layers=32,
                          num_attention_heads=20, hidden_act="gelu", projection_dim=1280)


def clip_tiny(vocab_size: int = 1000) -> CLIPTextConfig:
    return CLIPTextConfig(vocab_size=vocab_size, hidden_size=32, intermediate_size=64,
                          num_hidden_layers=2, num_attention_heads=4,
                          max_position_embeddings=77, projection_dim=32, eos_token_id=2)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _act(name: str):
    if name == "quick_gelu":
        return quick_gelu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown hidden_act {name!r}")


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
        y = self.fc2(_act(cfg.hidden_act)(self.fc1(self.layer_norm2(x))))
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


@dataclasses.dataclass(frozen=True)
class ClapTextConfig:
    """CLAP text branch (RoBERTa-style bidirectional encoder + projection),
    AudioLDM's prompt conditioning (512-d pooled)."""
    vocab_size: int = 50265
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 514
    projection_dim: int = 512
    dtype: torch.dtype = torch.float32


def clap_tiny(vocab_size: int = 1000) -> ClapTextConfig:
    return ClapTextConfig(vocab_size=vocab_size, hidden_size=32, intermediate_size=64,
                          num_hidden_layers=2, num_attention_heads=4, projection_dim=16)


class ClapTextModel(nn.Module):
    """forward(input_ids [B, T], attention_mask [B, T] or None) ->
    (last_hidden [B, T, hidden], pooled projection [B, projection_dim]).

    Post-norm layers with LayerNorm eps 1e-12 and tanh GELU; keys past each
    row's ``attention_mask.sum()`` are masked (the reference's kv_len); the
    first token is pooled, then a ReLU MLP projects it."""

    def __init__(self, cfg: ClapTextConfig, device=None):
        super().__init__()
        self.config = cfg
        Hd, dt = cfg.hidden_size, cfg.dtype
        lin = lambda i, o: nn.Linear(i, o, dtype=dt, device=device)
        ln = lambda: nn.LayerNorm(Hd, eps=1e-12, dtype=dt, device=device)
        self.token_embedding = nn.Embedding(cfg.vocab_size, Hd, dtype=dt, device=device)
        # Held in fp32 as the reference's param is, cast at use.
        self.position_embedding = nn.Parameter(torch.zeros(
            cfg.max_position_embeddings, Hd, dtype=torch.float32, device=device))
        self.embed_ln = ln()
        for i in range(cfg.num_hidden_layers):
            for name in ("q", "k", "v", "out"):
                self.add_module(f"l{i}_{name}", lin(Hd, Hd))
            self.add_module(f"l{i}_ln1", ln())
            self.add_module(f"l{i}_fc1", lin(Hd, cfg.intermediate_size))
            self.add_module(f"l{i}_fc2", lin(cfg.intermediate_size, Hd))
            self.add_module(f"l{i}_ln2", ln())
        self.proj_fc1 = lin(Hd, cfg.projection_dim)
        self.proj_fc2 = lin(cfg.projection_dim, cfg.projection_dim)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None):
        cfg = self.config
        B, T = input_ids.shape
        nh = cfg.num_attention_heads
        x = self.token_embedding(input_ids) + self.position_embedding[None, :T].to(cfg.dtype)
        x = self.embed_ln(x)
        if attention_mask is None:
            attention_mask = torch.ones((B, T), dtype=torch.int32, device=input_ids.device)
        kv_len = attention_mask.sum(dim=-1).to(torch.int32)
        heads = lambda t: t.reshape(B, T, nh, -1)
        for i in range(cfg.num_hidden_layers):
            layer = lambda name: getattr(self, f"l{i}_{name}")
            attn = mha_reference(heads(layer("q")(x)), heads(layer("k")(x)),
                                 heads(layer("v")(x)), causal=False, kv_len=kv_len)
            x = layer("ln1")(x + layer("out")(attn.reshape(B, T, -1)))
            y = layer("fc2")(F.gelu(layer("fc1")(x), approximate="tanh"))
            x = layer("ln2")(x + y)
        p = self.proj_fc2(torch.relu(self.proj_fc1(x[:, 0])))
        return x, p
