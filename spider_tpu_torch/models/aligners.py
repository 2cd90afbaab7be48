"""Alignment projectors: map LLM hidden states at signal-token positions into
the conditioning spaces of the frozen task decoders (counterpart of
spider_tpu/models/aligners.py).

  * TextFcLayer: 'linear' | 'transformer' (4+4-layer encoder-decoder with
    learned query embeddings, 1 -> 77 tokens) | 'qformer' (BERT-style
    cross-attention queries)
  * TextFcLayerMoE: 'moe_transformer' (3 experts x (fc + encoder-decoder),
    per-modality sigmoid routers, out_fc and learned modality query tokens,
    optional reconstruction branch) and 'moe_aligner' (encoder/decoder with
    77 cross-attention queries).

Submodule and parameter names follow the flax tree (``enc0_ln1``,
``expert_fc_0``, ``router_IMAGE`` ...) so ``convert.load_jax_params`` fills
them. GELU is the tanh form and LayerNorm's eps is 1e-6, as flax's defaults
are. Attention is ``ops.attention.plain_attention``, the einsum with an fp32
softmax: fp32 at T <= 257 is not the flash kernels' work, so no kernel
launches here.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from spider_tpu_torch.ops.attention import plain_attention


LN_EPS = 1e-6


class Mlp(nn.Module):
    def __init__(self, in_features: int, hidden_features: int, out_features: int,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features, dtype=dtype, device=device)
        self.fc2 = nn.Linear(hidden_features, out_features, dtype=dtype, device=device)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class _SelfAttn(nn.Module):
    def __init__(self, dim: int, heads: int, dtype, device=None):
        super().__init__()
        self.heads = heads
        for name in ("q", "k", "v", "out"):
            setattr(self, name, nn.Linear(dim, dim, dtype=dtype, device=device))

    def forward(self, x, context=None):
        ctx = x if context is None else context
        return self.out(plain_attention(self.q(x), self.k(ctx), self.v(ctx), self.heads))


class EncDecTransformer(nn.Module):
    """Pre-LN encoder-decoder: src -> memory; queries cross-attend to it."""

    def __init__(self, dim: int, num_layers: int = 4, heads: int = 4, ff_mult: int = 4,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.num_layers = num_layers
        kw = dict(dtype=dtype, device=device)
        ln = lambda: nn.LayerNorm(dim, eps=LN_EPS, **kw)
        for i in range(num_layers):
            setattr(self, f"enc{i}_ln1", ln())
            setattr(self, f"enc{i}_attn", _SelfAttn(dim, heads, **kw))
            setattr(self, f"enc{i}_ln2", ln())
            setattr(self, f"enc{i}_fc1", nn.Linear(dim, dim * ff_mult, **kw))
            setattr(self, f"enc{i}_fc2", nn.Linear(dim * ff_mult, dim, **kw))
        self.enc_ln_out = ln()
        for i in range(num_layers):
            setattr(self, f"dec{i}_ln1", ln())
            setattr(self, f"dec{i}_self", _SelfAttn(dim, heads, **kw))
            setattr(self, f"dec{i}_ln2", ln())
            setattr(self, f"dec{i}_cross", _SelfAttn(dim, heads, **kw))
            setattr(self, f"dec{i}_ln3", ln())
            setattr(self, f"dec{i}_fc1", nn.Linear(dim, dim * ff_mult, **kw))
            setattr(self, f"dec{i}_fc2", nn.Linear(dim * ff_mult, dim, **kw))
        self.dec_ln_out = ln()

    def forward(self, src, queries):
        m = lambda name: getattr(self, name)
        x = src
        for i in range(self.num_layers):
            x = x + m(f"enc{i}_attn")(m(f"enc{i}_ln1")(x))
            h = m(f"enc{i}_fc1")(m(f"enc{i}_ln2")(x))
            x = x + m(f"enc{i}_fc2")(F.relu(h))
        memory = self.enc_ln_out(x)
        y = queries.expand(src.shape[0], *queries.shape[-2:])
        for i in range(self.num_layers):
            y = y + m(f"dec{i}_self")(m(f"dec{i}_ln1")(y))
            y = y + m(f"dec{i}_cross")(m(f"dec{i}_ln2")(y), memory)
            h = m(f"dec{i}_fc1")(m(f"dec{i}_ln3")(y))
            y = y + m(f"dec{i}_fc2")(F.relu(h))
        return self.dec_ln_out(y)


class QFormerBlock(nn.Module):
    """Self-attention over the queries, then cross-attention to the encoder
    states, each followed by a post-LayerNorm; no FFN."""

    def __init__(self, dim: int, heads: int, dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.self_attn = _SelfAttn(dim, heads, **kw)
        self.ln1 = nn.LayerNorm(dim, eps=LN_EPS, **kw)
        self.cross_attn = _SelfAttn(dim, heads, **kw)
        self.ln2 = nn.LayerNorm(dim, eps=LN_EPS, **kw)

    def forward(self, queries, enc_states):
        queries = self.ln1(queries + self.self_attn(queries))
        return self.ln2(queries + self.cross_attn(queries, enc_states))


def _query(shape, std: float, device) -> nn.Parameter:
    """A learned query tensor, fp32 like the flax parameter."""
    return nn.Parameter(std * torch.randn(shape, dtype=torch.float32, device=device))


class TextFcLayer(nn.Module):
    """Maps (N, T_in, in_dim) -> (N, num_output_tokens, out_dim)."""

    def __init__(self, in_dim: int, out_dim: int, num_input_tokens: int = 1,
                 num_output_tokens: int = 1, mode: str = "transformer",
                 hidden_dim: int = 512, dtype=torch.float32, device=None):
        super().__init__()
        self.mode, self.dtype, self.num_output_tokens = mode, dtype, num_output_tokens
        kw = dict(dtype=dtype, device=device)
        if mode == "linear":
            self.model = nn.Linear(in_dim, out_dim, **kw)
        elif mode == "transformer":
            self.fc = nn.Linear(in_dim, hidden_dim, **kw)
            self.query_embs = _query((1, num_output_tokens, hidden_dim), 1.0, device)
            self.tfm = EncDecTransformer(hidden_dim, **kw)
            self.model = nn.Linear(hidden_dim, out_dim, **kw)
        elif mode == "qformer":
            hidden = 768
            self.fc = nn.Linear(in_dim, hidden, **kw)
            self.query_tokens = _query((1, num_output_tokens, hidden), 0.02, device)
            self.qformer_0 = QFormerBlock(hidden, 12, **kw)
            self.qformer_1 = QFormerBlock(hidden, 12, **kw)
            self.model = nn.Linear(hidden, out_dim, **kw)
        else:
            raise NotImplementedError(mode)

    def forward(self, x, modality: Optional[str] = None):
        x = x.to(self.dtype)
        if self.mode == "linear":
            return self.model(x)[:, : self.num_output_tokens]
        if self.mode == "transformer":
            h = self.tfm(self.fc(x), self.query_embs.to(self.dtype))
            return self.model(h)
        h = self.fc(x)
        q = self.query_tokens.to(self.dtype).expand(x.shape[0], -1, -1)
        q = self.qformer_1(self.qformer_0(q, h), h)
        return self.model(q)


def _routing_weights(router: Mlp, x: torch.Tensor) -> torch.Tensor:
    """[b, T, C] -> [b, 1, E] sigmoid weights normalised to sum 1."""
    w = torch.sigmoid(router(x.mean(dim=1, keepdim=True)))
    return w / w.sum(dim=-1, keepdim=True)


class TextFcLayerMoE(nn.Module):
    """Shared-expert MoE aligner serving all modalities from one module.

    output_alignment_modules: {modality: dict(alignment_output_tokens,
    alignment_output_dim, ...)}. The flax module creates a modality's router,
    query tokens and output layers when that modality is first applied; here
    every modality listed gets them at construction.
    """

    def __init__(self, in_dim: int, output_alignment_modules: Dict[str, Dict],
                 mode: str = "moe_transformer", reconstruct_loss: bool = False,
                 num_experts: int = 3, num_expert_layers: int = 4, hidden_dim: int = 512,
                 num_rec_tokens: int = 1024, dtype=torch.float32, device=None):
        super().__init__()
        self.mods = output_alignment_modules
        self.mode, self.reconstruct_loss, self.dtype = mode, reconstruct_loss, dtype
        self.num_experts, self.num_rec_tokens = num_experts, num_rec_tokens
        kw = dict(dtype=dtype, device=device)
        if mode == "moe_transformer":
            for e in range(num_experts):
                setattr(self, f"expert_fc_{e}", nn.Linear(in_dim, hidden_dim, **kw))
                setattr(self, f"expert_tfm_{e}",
                        EncDecTransformer(hidden_dim, num_expert_layers, **kw))
                if reconstruct_loss:
                    setattr(self, f"rec_expert_tfm_{e}",
                            EncDecTransformer(hidden_dim, num_expert_layers, **kw))
            for m, spec in output_alignment_modules.items():
                setattr(self, f"router_{m}", Mlp(in_dim, in_dim, num_experts, **kw))
                setattr(self, f"modality_tokens_{m}",
                        _query((1, spec["alignment_output_tokens"], hidden_dim), 1.0, device))
                setattr(self, f"out_fc_{m}",
                        nn.Linear(hidden_dim, spec["alignment_output_dim"], **kw))
                if reconstruct_loss:
                    setattr(self, f"rec_out_fc_{m}",
                            nn.Linear(spec["alignment_output_dim"], hidden_dim, **kw))
                    setattr(self, f"rec_router_{m}",
                            Mlp(hidden_dim, hidden_dim, num_experts, **kw))
                    setattr(self, f"rec_modality_tokens_{m}",
                            _query((num_rec_tokens, hidden_dim), 1.0, device))
                    setattr(self, f"rec_out_fc2_{m}", nn.Linear(hidden_dim, in_dim, **kw))
        elif mode == "moe_aligner":
            hidden = 768
            self.encoder_proj = nn.Linear(in_dim, hidden, **kw)
            self.encoder_query = _query((1, 77, hidden), 1.0, device)
            self.aligner = EncDecTransformer(hidden, 6, heads=8, **kw)
            if reconstruct_loss:
                self.decoder_query = _query((1, 1024, hidden), 1.0, device)
                self.rec_decoder = EncDecTransformer(hidden, 6, heads=8, **kw)
                self.decoder_proj = nn.Linear(hidden, in_dim, **kw)
        else:
            raise NotImplementedError(mode)

    def _mixture(self, prefix: str, src, queries, w):
        """sum_e w[..., e] * tfm_e(src_e, queries); src is a list per expert."""
        out = 0
        for e in range(self.num_experts):
            h = getattr(self, f"{prefix}_{e}")(src[e], queries)
            out = out + h * w[:, :, e:e + 1]
        return out

    def forward(self, x, modality: str = "IMAGE"):
        x = x.to(self.dtype)
        if self.mode == "moe_aligner":
            out = self.aligner(self.encoder_proj(x), self.encoder_query.to(self.dtype))
            if not self.reconstruct_loss:
                return out
            rec = self.rec_decoder(out, self.decoder_query[:, : x.shape[1]].to(self.dtype))
            return out, self.decoder_proj(rec)
        m = lambda name: getattr(self, f"{name}_{modality}")
        w = _routing_weights(m("router"), x)
        src = [getattr(self, f"expert_fc_{e}")(x) for e in range(self.num_experts)]
        h = self._mixture("expert_tfm", src, m("modality_tokens").to(self.dtype), w)
        out = m("out_fc")(h)
        if not self.reconstruct_loss:
            return out
        # Reconstruction branch: project back toward the LLM embedding space.
        num_tokens = x.shape[1]
        if num_tokens > self.num_rec_tokens and self.num_rec_tokens != 1:
            return out, x
        r = m("rec_out_fc")(out)
        rw = _routing_weights(m("rec_router"), r)
        rec_tokens = m("rec_modality_tokens")
        if self.num_rec_tokens == 1:
            rq = rec_tokens.repeat(num_tokens, 1)[None]
        else:
            rq = rec_tokens[:num_tokens][None]
        rec = self._mixture("rec_expert_tfm", [r] * self.num_experts, rq.to(self.dtype), rw)
        return out, m("rec_out_fc2")(rec)
