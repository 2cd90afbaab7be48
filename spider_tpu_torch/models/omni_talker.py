"""Qwen2.5-Omni "talker" in PyTorch (counterpart of spider_tpu/models/omni_talker.py):
speech-codec tokens from the thinker's reply.

A Qwen2-architecture decoder that takes, at each position, the sum of a
codec-token embedding and a thinker-stream row (the thinker's last-layer
hidden + token embedding there), projects it to its own width with
``thinker_to_talker_proj`` and predicts the next codec token with
``codec_head`` (8448 ids: 8192 codebook entries and special ids):

  * prefill inputs = [the thinker's prompt rows, the speaker's text-BOS
    embedding, the first reply row], the codec PAD embedding added at row -2
    and codec BOS at row -1;
  * each decode step embeds the codec token sampled last and adds the next
    reply row; the reply rows are followed by the thinker's text-EOS and then
    text-PAD embeddings, and the last row repeats once they are used up;
  * sampling in HF generate's order: repetition penalty over the ids seen
    so far, codec BOS suppressed, temperature, top-k, top-p, then a draw
    from a ``torch.Generator``; generation stops on codec EOS or PAD.

The decoder body is the port's ``LlamaModel`` (q/k/v biases, GQA, m-RoPE),
so the prefill runs the flash kernel and each decode step plain attention
over the cache. The reference holds the talker's parameters in fp32 and
computes every product in bf16 (flax Dense with dtype bf16); the port holds
its projections and embeddings in ``param_dtype`` (``talker_full`` keeps
fp32; the full-size builders pass bf16, which rounds each weight to the bf16
the reference casts it to before every product) and its RMSNorm scales in
fp32, so both hold the same products.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from spider_tpu_torch.models import llama as L


@dataclasses.dataclass(frozen=True)
class OmniTalkerConfig:
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_hidden_layers: int = 28
    num_attention_heads: int = 28
    num_key_value_heads: int = 4
    head_dim: int = 128
    rope_theta: float = 1000000.0
    rms_norm_eps: float = 1e-6
    mrope_section: Optional[Tuple[int, ...]] = None
    # codec tokens are embedded at the THINKER's width, so that they sum
    # with thinker rows before the projection
    embedding_size: int = 3584
    vocab_size: int = 8448           # codec codebook + special ids
    codec_bos: int = 8293
    codec_eos: int = 8294
    codec_pad: int = 8292
    codec_mask: int = 8296
    # tts text ids in the THINKER's vocabulary, embedded by its embed_tokens
    text_bos: int = 151860
    text_eos: int = 151861
    text_pad: int = 151859
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    def as_llama(self) -> L.LlamaConfig:
        return L.LlamaConfig(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            num_hidden_layers=self.num_hidden_layers,
            num_attention_heads=self.num_attention_heads,
            num_key_value_heads=self.num_key_value_heads, head_dim=self.head_dim,
            rope_theta=self.rope_theta, rms_norm_eps=self.rms_norm_eps, attention_bias=True,
            mrope_section=self.mrope_section, dtype=self.dtype, param_dtype=self.param_dtype)


def talker_full() -> OmniTalkerConfig:
    # the released 7B checkpoint carries mrope_section [16, 24, 24]
    return OmniTalkerConfig(mrope_section=(16, 24, 24))


def talker_tiny(vocab_size: int = 32) -> OmniTalkerConfig:
    return OmniTalkerConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, head_dim=8, mrope_section=(2, 1, 1), embedding_size=48,
        vocab_size=vocab_size, codec_bos=vocab_size - 3, codec_eos=vocab_size - 2,
        codec_pad=vocab_size - 4, codec_mask=vocab_size - 1, text_bos=5, text_eos=6,
        text_pad=7, dtype=torch.float32)


class OmniTalker(nn.Module):
    """inputs_embeds [B, T, embedding_size] (codec embeddings + thinker rows,
    summed by the caller) -> (codec logits [B, T, vocab], kv_cache)."""

    def __init__(self, cfg: OmniTalkerConfig, device=None):
        super().__init__()
        self.config = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.embedding_size,
                                         dtype=cfg.param_dtype, device=device)
        self.thinker_to_talker_proj = L.LoraDense(cfg.embedding_size, cfg.hidden_size,
                                                  cfg.dtype, cfg.param_dtype, device=device,
                                                  use_bias=True)
        self.model = L.LlamaModel(cfg.as_llama(), device)
        # The RMSNorm scales stay fp32 whatever param_dtype is: the
        # reference multiplies by its fp32 scales.
        for mod in self.model.modules():
            for name in ("input_layernorm", "post_attention_layernorm", "norm"):
                p = getattr(mod, name, None)
                if isinstance(p, nn.Parameter) and p.dtype != torch.float32:
                    setattr(mod, name, nn.Parameter(p.detach().float()))
        self.codec_head = L.LoraDense(cfg.hidden_size, cfg.vocab_size, cfg.dtype,
                                      cfg.param_dtype, device=device)

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.weight.device

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embed_tokens(ids).to(self.config.dtype)

    def forward(self, inputs_embeds, positions, kv_write_index=0, kv_cache=None, kv_len=None):
        """positions: [3, B, T] (m-RoPE) or [B, T]."""
        x = self.thinker_to_talker_proj(inputs_embeds.to(self.config.dtype))
        final, _, kv_cache = self.model(x, positions, kv_write_index, kv_cache, kv_len)
        return self.codec_head(final), kv_cache


# --------------------------------------------------------------- generation

@dataclasses.dataclass
class TalkerSampling:
    """HF Qwen2_5OmniForConditionalGeneration.generate talker defaults."""
    temperature: float = 0.9
    top_k: int = 40
    top_p: float = 0.8
    repetition_penalty: float = 1.05
    max_new_tokens: int = 4096


def filter_logits(logits: torch.Tensor, presence: torch.Tensor, s: TalkerSampling,
                  codec_bos: int, suppress: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[V] fp32 logits -> the logits the draw is made from, in the
    reference's order: the repetition penalty on the ids in `presence` [V]
    (bool), codec BOS (and the ids in `suppress` [V], bool) set to -inf, the
    temperature, top-k (ties with the k-th kept), then top-p (the ids below
    the first sorted logit whose cumulative probability reaches top_p set to
    -inf)."""
    pen = torch.where(logits < 0, logits * s.repetition_penalty, logits / s.repetition_penalty)
    logits = torch.where(presence, pen, logits)
    logits = logits.clone()
    logits[codec_bos] = float("-inf")
    if suppress is not None:
        logits = logits.masked_fill(suppress, float("-inf"))
    logits = logits / s.temperature
    ninf = torch.full_like(logits, float("-inf"))
    if s.top_k and s.top_k < logits.shape[-1]:
        kth = torch.topk(logits, s.top_k).values[-1]
        logits = torch.where(logits < kth, ninf, logits)
    if s.top_p < 1.0:
        srt = torch.sort(logits, descending=True).values
        cum = torch.cumsum(torch.softmax(srt, dim=-1), dim=-1)
        # JAX clamps the index; kept on the device, no wait for it
        cutoff = (cum < s.top_p).sum().clamp(max=srt.shape[-1] - 1)
        logits = torch.where(logits < srt[cutoff], ninf, logits)
    return logits


def sample_codec(logits: torch.Tensor, presence: torch.Tensor, s: TalkerSampling,
                 codec_bos: int, generator: Optional[torch.Generator],
                 suppress: Optional[torch.Tensor] = None) -> int:
    """One codec id drawn from ``filter_logits`` by `generator`."""
    probs = torch.softmax(filter_logits(logits.float(), presence, s, codec_bos, suppress),
                          dim=-1)
    return int(torch.multinomial(probs, 1, generator=generator)[0])


class OmniTalkerGenerator:
    """Codec tokens from the thinker's streams: the prefill, then one decode
    step a token, as the reference's HF-style stitching does."""

    def __init__(self, talker: OmniTalker, sampling: Optional[TalkerSampling] = None):
        self.talker = talker
        self.s = sampling or TalkerSampling()

    def _embed(self, tid: int) -> torch.Tensor:
        t = self.talker
        return t.embed(torch.tensor([tid], dtype=torch.long, device=t.device))[0].float()

    def generate(self, prompt_stream: np.ndarray, text_bos_embed: np.ndarray,
                 reply_stream: np.ndarray, eos_embed: np.ndarray, pad_embed: np.ndarray,
                 prefill_positions: Optional[np.ndarray] = None,
                 max_new_tokens: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 voiceable: Optional[int] = None) -> np.ndarray:
        """prompt_stream [P, E]: the thinker's prompt rows (multimodal rows'
        embeddings zeroed by the caller); text_bos/eos/pad_embed [E];
        reply_stream [R, E]: the rows of the thinker's reply tokens. Returns
        the codec ids up to the first EOS or PAD: the first id drawn from the
        prefill's logits, then up to `max_new_tokens` more, one a step, each
        drawn by `generator`. With `voiceable`, the ids from it up, other
        than EOS and PAD, are suppressed beside BOS (ROADMAP C15: token2wav
        has no codebook row for them)."""
        talker = self.talker
        cfg, dev = talker.config, talker.device
        max_new = int(max_new_tokens or self.s.max_new_tokens)
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        with torch.inference_mode():
            # An empty reply (the thinker's EOS came first) has no first row:
            # the text-BOS row stands in, so the codec adds land on the last
            # two rows.
            head = f32(reply_stream[:1]) if len(reply_stream) else f32(text_bos_embed)[None]
            pre = torch.cat([f32(prompt_stream), f32(text_bos_embed)[None], head])
            pre[-2] += self._embed(cfg.codec_pad)
            pre[-1] += self._embed(cfg.codec_bos)
            T = pre.shape[0]
            if prefill_positions is None:
                positions = torch.arange(T, dtype=torch.int32, device=dev)[None, None].expand(
                    3, 1, T)
            else:
                positions = torch.as_tensor(np.asarray(prefill_positions), dtype=torch.int32,
                                            device=dev)
                assert tuple(positions.shape) == (3, 1, T), tuple(positions.shape)
            cache = L.init_kv_cache(cfg.as_llama(), 1, T + max_new, device=dev)
            logits, cache = talker(pre[None], positions=positions, kv_write_index=0,
                                   kv_cache=cache,
                                   kv_len=torch.tensor([T], dtype=torch.int32, device=dev))
            # decode-time rows: reply[1:] ++ text_eos ++ text_pad, the last
            # repeating
            stream = torch.cat([f32(reply_stream[1:]).reshape(-1, pre.shape[1]),
                                f32(eos_embed)[None], f32(pad_embed)[None]])
            R = stream.shape[0]
            presence = torch.zeros(cfg.vocab_size, dtype=torch.bool, device=dev)
            presence[[cfg.codec_mask, cfg.codec_pad, cfg.codec_bos]] = True
            stop = (cfg.codec_eos, cfg.codec_pad)
            suppress = None
            if voiceable is not None:
                suppress = torch.zeros(cfg.vocab_size, dtype=torch.bool, device=dev)
                suppress[voiceable:] = True
                suppress[list(stop)] = False
            tok = sample_codec(logits[0, -1], presence, self.s, cfg.codec_bos, generator,
                               suppress)
            out = []
            nxt_pos = int(positions.max()) + 1
            for i in range(max_new + 1):
                if tok in stop:
                    break
                out.append(tok)
                presence[tok] = True
                if i == max_new:
                    break
                # the codec embedding (in dtype) plus an fp32 row: the sum
                # in fp32, rounded to dtype by the projection, as in JAX
                emb = talker.embed(torch.tensor([[tok]], dtype=torch.long, device=dev)).float() \
                    + stream[min(i, R - 1)]
                pos = torch.full((3, 1, 1), nxt_pos + i, dtype=torch.int32, device=dev)
                logits, cache = talker(emb, positions=pos, kv_write_index=T + i,
                                       kv_cache=cache,
                                       kv_len=torch.tensor([T + i + 1], dtype=torch.int32,
                                                           device=dev))
                tok = sample_codec(logits[0, -1], presence, self.s, cfg.codec_bos, generator,
                                   suppress)
        return np.asarray(out, np.int32)


def build_tiny_talker(*, device="cpu", seed: int = 0, embedding_size: Optional[int] = None):
    """Random tiny talker (fp32), for tests and smokes."""
    from spider_tpu_torch.models.factory import random_init_

    cfg = talker_tiny()
    if embedding_size is not None:
        cfg = dataclasses.replace(cfg, embedding_size=embedding_size)
    gen = torch.Generator(device=device).manual_seed(seed)
    return random_init_(OmniTalker(cfg, device).eval(), gen)
