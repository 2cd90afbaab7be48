"""BERT encoder (counterpart of spider_tpu/models/bert.py): Grounding
DINO's language model, structured for HF bert-base-uncased weights: word,
position and token-type embeddings with a LayerNorm, post-LN layers, a tanh
pooler. Names follow the JAX tree; LayerNorm's eps is the config's (1e-12)
and GELU the tanh form, jax.nn.gelu's default. Attention is the plain
``mha_reference`` with the live lengths of a padded batch (``kv_len``), as
the reference computes it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from spider_tpu_torch.ops.attention import mha_reference


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dtype: torch.dtype = torch.float32


def bert_base() -> BertConfig:
    return BertConfig()


def bert_test() -> BertConfig:
    return BertConfig(vocab_size=300, hidden_size=32, num_hidden_layers=2,
                      num_attention_heads=4, intermediate_size=64)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        C, kw = cfg.hidden_size, dict(dtype=cfg.dtype, device=device)
        self.heads = cfg.num_attention_heads
        for name in ("query", "key", "value", "attn_out"):
            setattr(self, name, nn.Linear(C, C, **kw))
        self.attn_ln = nn.LayerNorm(C, eps=cfg.layer_norm_eps, **kw)
        self.intermediate = nn.Linear(C, cfg.intermediate_size, **kw)
        self.output = nn.Linear(cfg.intermediate_size, C, **kw)
        self.out_ln = nn.LayerNorm(C, eps=cfg.layer_norm_eps, **kw)

    def forward(self, x: torch.Tensor, kv_len: Optional[torch.Tensor]) -> torch.Tensor:
        B, T, C = x.shape
        H = self.heads
        split = lambda t: t.reshape(B, T, H, C // H)
        attn = mha_reference(split(self.query(x)), split(self.key(x)), split(self.value(x)),
                             causal=False, kv_len=kv_len)
        x = self.attn_ln(x + self.attn_out(attn.reshape(B, T, C)))
        h = self.output(F.gelu(self.intermediate(x), approximate="tanh"))
        return self.out_ln(x + h)


class BertModel(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.config = cfg
        C, kw = cfg.hidden_size, dict(dtype=cfg.dtype, device=device)
        self.word_embeddings = nn.Embedding(cfg.vocab_size, C, **kw)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, C, **kw)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, C, **kw)
        self.embed_ln = nn.LayerNorm(C, eps=cfg.layer_norm_eps, **kw)
        for i in range(cfg.num_hidden_layers):
            setattr(self, f"layer_{i}", BertLayer(cfg, device))
        self.pooler = nn.Linear(C, C, **kw)

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None):
        """input_ids [B, T] -> (hidden [B, T, C], pooled [B, C])."""
        B, T = input_ids.shape
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        pos = torch.arange(T, device=input_ids.device)[None].expand(B, T)
        x = self.embed_ln(self.word_embeddings(input_ids) + self.position_embeddings(pos)
                          + self.token_type_embeddings(token_type_ids))
        kv_len = attention_mask.sum(-1).to(torch.int32) if attention_mask is not None else None
        for i in range(self.config.num_hidden_layers):
            x = getattr(self, f"layer_{i}")(x, kv_len)
        return x, torch.tanh(self.pooler(x[:, 0]))
