"""Standalone Kosmos-G-style aligner (counterpart of
spider_tpu/models/aligner.py; optional, not on Spider's live path).

Maps LLM hidden-state sequences into CLIP text-encoder space with a 77-query
cross-attention bottleneck, supervised by (a) MSE against the frozen CLIP
text embeddings and (b) a reconstruction branch decoding the 77 queries back
to the input sequence. Built on ``aligners.EncDecTransformer``; names follow
the flax tree.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from spider_tpu_torch.models.aligners import EncDecTransformer


@dataclasses.dataclass(frozen=True)
class AlignerConfig:
    llm_dim: int = 4096
    clip_dim: int = 768
    num_queries: int = 77
    max_positions: int = 1024
    dtype: torch.dtype = torch.float32


class AlignerEncoder(nn.Module):
    """Inference-only half: sequence [B, T, llm_dim] -> 77 aligned tokens."""

    def __init__(self, config: AlignerConfig, device=None):
        super().__init__()
        cfg = self.config = config
        kw = dict(dtype=cfg.dtype, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        self.in_proj = nn.Linear(cfg.llm_dim, cfg.clip_dim, **kw)
        self.positions = nn.Parameter(0.02 * torch.randn(cfg.max_positions, cfg.clip_dim, **f32))
        self.encoder_query = nn.Parameter(torch.randn(cfg.num_queries, cfg.clip_dim, **f32))
        self.encoder = EncDecTransformer(cfg.clip_dim, **kw)

    def forward(self, condition: torch.Tensor,
                padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = self.config.dtype
        T = condition.shape[1]
        x = self.in_proj(condition.to(dt)) + self.positions[None, :T].to(dt)
        if padding_mask is not None:
            x = x * (1.0 - padding_mask[..., None].to(x.dtype))
        return self.encoder(x, self.encoder_query[None].to(dt))


class Aligner(AlignerEncoder):
    """forward(condition [B,T,llm_dim], clip_embed [B,77,clip_dim]) ->
    {'aligned', 'mse_loss' (when clip_embed is given), 'rec_loss'}."""

    def __init__(self, config: AlignerConfig, device=None):
        super().__init__(config, device)
        cfg = config
        self.decoder_query = nn.Parameter(torch.randn(
            cfg.max_positions, cfg.clip_dim, dtype=torch.float32, device=device))
        self.decoder = EncDecTransformer(cfg.clip_dim, dtype=cfg.dtype, device=device)
        self.out_proj = nn.Linear(cfg.clip_dim, cfg.llm_dim, dtype=cfg.dtype, device=device)

    def forward(self, condition: torch.Tensor, clip_embed: Optional[torch.Tensor] = None,
                padding_mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        cfg = self.config
        T = condition.shape[1]
        aligned = super().forward(condition, padding_mask)
        out = {"aligned": aligned}
        if clip_embed is not None:
            out["mse_loss"] = ((aligned.float() - clip_embed.float()) ** 2).mean()
        # T learned queries decode the 77 aligned tokens back into the input
        # space; the loss is scaled by 77 / T.
        rec = self.decoder(aligned, self.decoder_query[None, :T].to(cfg.dtype))
        rec = self.out_proj(rec)
        out["rec_loss"] = ((rec.float() - condition.float()) ** 2).mean() * (cfg.num_queries / T)
        return out
