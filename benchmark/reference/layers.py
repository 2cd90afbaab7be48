"""Plain fp32 building blocks of the reference models.

Every matrix product goes through ``Lin`` or ``Conv``. With ``fp8`` set on a
module (``set_fp8``), both the input and the weight of the product are
rounded to float8 e4m3 under a per-tensor scale before it is taken: the
control that stands for a program computing its products in fp8. Attention
is the plain softmax form in fp32, in blocks of batch rows so that the
largest logits fit on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

E4M3_MAX = 448.0
# fp32 logits of one attention block: at ZeroScope's level 0 (8 heads over
# 2880 positions) that is 3 rows of the 32 frames of the CFG pair.
ATTN_BLOCK_BYTES = 1 << 30


def fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale that maps its largest
    magnitude to the format's largest, and back to x's dtype."""
    scale = x.abs().amax().clamp_min(1e-12) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class Lin(nn.Linear):
    fp8 = False

    def forward(self, x):
        if self.fp8:
            return F.linear(fake_fp8(x), fake_fp8(self.weight), self.bias)
        return super().forward(x)


class Conv(nn.Conv2d):
    fp8 = False

    def forward(self, x):
        if self.fp8:
            return self._conv_forward(fake_fp8(x), fake_fp8(self.weight), self.bias)
        return super().forward(x)


def set_fp8(model: nn.Module, on: bool) -> nn.Module:
    for m in model.modules():
        if isinstance(m, (Lin, Conv)):
            m.fp8 = on
    return model


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
              causal: bool = False) -> torch.Tensor:
    """Softmax attention on [B, T, C] projections (keys [B, S, C]), heads of
    C // heads, scale 1/sqrt(head dim), in fp32."""
    B, T, C = q.shape
    S = k.shape[1]
    D = C // heads
    rows = max(1, ATTN_BLOCK_BYTES // (4 * heads * T * S))
    out = torch.empty_like(q)
    for b in range(0, B, rows):
        qb = q[b:b + rows].reshape(-1, T, heads, D).transpose(1, 2)
        kb = k[b:b + rows].reshape(-1, S, heads, D).transpose(1, 2)
        vb = v[b:b + rows].reshape(-1, S, heads, D).transpose(1, 2)
        logits = (qb @ kb.transpose(-1, -2)) / D ** 0.5
        if causal:
            mask = torch.ones(T, S, dtype=torch.bool, device=q.device).tril(S - T)
            logits = logits.masked_fill(~mask, float("-inf"))
        o = torch.softmax(logits, dim=-1) @ vb
        out[b:b + rows] = o.transpose(1, 2).reshape(-1, T, C)
    return out


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")
