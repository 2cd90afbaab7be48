"""CLIP text encoder, plain fp32: pre-norm causal layers, the final
LayerNorm's output is the conditioning. Parameter names are those of the
weights the benchmark fills (``layers_<i>.q_proj``, ...)."""

from __future__ import annotations

import torch
from torch import nn

from benchmark.reference.layers import Lin, attention, gelu_tanh


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


ACTS = {"quick_gelu": quick_gelu, "gelu_tanh": gelu_tanh}


class EncoderLayer(nn.Module):
    def __init__(self, hidden: int, inter: int, heads: int, act: str):
        super().__init__()
        self.heads, self.act = heads, ACTS[act]
        self.layer_norm1 = nn.LayerNorm(hidden, eps=1e-5)
        self.q_proj, self.k_proj, self.v_proj = (Lin(hidden, hidden) for _ in range(3))
        self.out_proj = Lin(hidden, hidden)
        self.layer_norm2 = nn.LayerNorm(hidden, eps=1e-5)
        self.fc1 = Lin(hidden, inter)
        self.fc2 = Lin(inter, hidden)

    def forward(self, x):
        y = self.layer_norm1(x)
        a = attention(self.q_proj(y), self.k_proj(y), self.v_proj(y), self.heads, causal=True)
        x = x + self.out_proj(a)
        return x + self.fc2(self.act(self.fc1(self.layer_norm2(x))))


class CLIPText(nn.Module):
    """forward(ids [B, T]) -> final-normed hidden states [B, T, hidden]."""

    def __init__(self, cfg: dict):
        super().__init__()
        H = cfg["hidden_size"]
        self.n = cfg["num_hidden_layers"]
        self.token_embedding = nn.Embedding(cfg["vocab_size"], H)
        self.position_embedding = nn.Parameter(torch.zeros(cfg["max_position_embeddings"], H))
        for i in range(self.n):
            self.add_module(f"layers_{i}", EncoderLayer(H, cfg["intermediate_size"],
                                                        cfg["num_attention_heads"],
                                                        cfg["act_as_run"]))
        self.final_layer_norm = nn.LayerNorm(H, eps=1e-5)

    def forward(self, ids):
        x = self.token_embedding(ids) + self.position_embedding[None, :ids.shape[1]]
        for i in range(self.n):
            x = getattr(self, f"layers_{i}")(x)
        return self.final_layer_norm(x)
