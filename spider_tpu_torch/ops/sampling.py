"""Token sampling for autoregressive decode (greedy / temperature / top-p),
counterpart of spider_tpu/ops/sampling.py. Randomness comes only from the
``torch.Generator`` the caller passes, never from the global RNG."""

from __future__ import annotations

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """logits [B, V] -> token ids [B] (int32; the first maximum on ties)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample_top_p(logits: torch.Tensor, generator: torch.Generator, *,
                 temperature: float = 1.0, top_p: float = 1.0) -> torch.Tensor:
    """Nucleus sampling. logits [B, V] -> token ids [B] (int32)."""
    if temperature <= 0.0:
        return greedy(logits)
    if generator is None:
        raise ValueError("sampling needs an explicit torch.Generator")
    logits = logits.float() / temperature
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # Keep tokens until cumulative prob exceeds top_p (always keep top-1).
        cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True).clamp_max(logits.shape[-1] - 1)
        cutoff_val = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff_val, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
