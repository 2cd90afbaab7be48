"""Qwen2.5-Omni "thinker" in PyTorch (counterpart of spider_tpu/models/qwen_omni.py):
any-modality in, text out.

  * audio tower: a Whisper-style encoder over chunks of n_window * 2 mel
    frames: per-chunk conv stem (k3 s1, gelu, the padded frames zeroed, k3 s2,
    gelu), per-chunk sinusoidal positions, pre-LN layers whose attention masks
    the padded keys of each chunk (k_proj has no bias), then pooling by 2,
    ``ln_post`` and ``proj`` to the thinker's width.
  * vision tower: the Qwen2.5-VL ViT: a bias-free patch embedding over
    (C, temporal_patch, p, p) vectors, 2-D rotary in rotate-half form on fp32
    copies, RMSNorm blocks with q/k/v biases and a SwiGLU MLP with biases,
    windowed attention (block-diagonal over windows) with full attention at
    ``fullatt_block_indexes``, and the 2x2 merger.
  * thinker LLM: models/llama.py with ``mrope_section`` (3-D positions from
    ``build_mrope_positions``). Its prefill runs the flash kernel; decode
    steps run plain attention over the cache, as the reference's einsum does.

The towers' attention stays plain PyTorch with the reference's masks
(``audio_attention``, ``vision_attention``): the reference computes it as
XLA einsums, not a Pallas kernel. GELU is the tanh form, the default of
flax's ``nn.gelu`` that the reference takes (ROADMAP C1); LayerNorm's eps is
flax's 1e-6. Submodule names follow the JAX tree (``layer_<i>``,
``block_<i>``, ``merge_fc1``, ...), so ``convert.load_jax_params`` fills the
port from the JAX params.

The host helpers (``sinusoid_positions``, ``audio_chunk_lengths``,
``patchify_image``, ``patchify_video``, ``vision_window_meta``, ``MMSegment``,
``build_mrope_positions``) are numpy copies of the reference's.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from spider_tpu_torch.models import llama as L
from spider_tpu_torch.ops.norms import layer_norm, rms_norm


# ----------------------------------------------------------------- configs

@dataclasses.dataclass(frozen=True)
class OmniAudioConfig:
    num_mel_bins: int = 128
    d_model: int = 1280
    num_layers: int = 32
    num_heads: int = 20
    ffn_dim: int = 5120
    n_window: int = 100                # attention chunk = n_window tokens
    max_positions: int = 1500
    output_dim: int = 3584             # thinker hidden
    dtype: torch.dtype = torch.float32


@dataclasses.dataclass(frozen=True)
class OmniVisionConfig:
    depth: int = 32
    hidden_size: int = 1280
    intermediate_size: int = 3420
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    spatial_merge_size: int = 2
    temporal_patch_size: int = 2
    window_size: int = 112
    out_hidden_size: int = 3584
    fullatt_block_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def omni_audio_full() -> OmniAudioConfig:
    return OmniAudioConfig()


def omni_vision_full() -> OmniVisionConfig:
    return OmniVisionConfig()


def omni_audio_tiny() -> OmniAudioConfig:
    return OmniAudioConfig(num_mel_bins=16, d_model=32, num_layers=2, num_heads=4, ffn_dim=64,
                           n_window=8, max_positions=64, output_dim=64)


def omni_vision_tiny() -> OmniVisionConfig:
    return OmniVisionConfig(depth=2, hidden_size=32, intermediate_size=64, num_heads=4,
                            patch_size=4, window_size=16, fullatt_block_indexes=(1,),
                            out_hidden_size=64)


def thinker_llm_full() -> L.LlamaConfig:
    """Qwen2.5-Omni-7B thinker text config (Qwen2_5OmniTextConfig defaults)."""
    return L.LlamaConfig(
        vocab_size=152064, hidden_size=3584, intermediate_size=18944,
        num_hidden_layers=28, num_attention_heads=28, num_key_value_heads=4,
        max_position_embeddings=32768, rms_norm_eps=1e-6,
        rope_theta=1000000.0, attention_bias=True,
        mrope_section=(16, 24, 24))


def thinker_tiny_llm() -> L.LlamaConfig:
    tiny = L.llama_tiny(vocab_size=512)
    d2 = (tiny.hidden_size // tiny.num_attention_heads) // 2
    return dataclasses.replace(tiny, attention_bias=True,
                               mrope_section=(d2 - 2 * (d2 // 3), d2 // 3, d2 // 3))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class LayerNorm(nn.LayerNorm):
    """flax nn.LayerNorm: eps 1e-6, fp32 parameters and statistics, the
    result in the input's dtype."""

    def __init__(self, C: int, eps: float = 1e-6, device=None):
        super().__init__(C, eps=eps, dtype=torch.float32, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


# ------------------------------------------------------------ audio tower

def sinusoid_positions(length: int, channels: int,
                       max_timescale: float = 10000.0) -> np.ndarray:
    """transformers SinusoidsPositionEmbedding (non-persistent buffer)."""
    inc = math.log(max_timescale) / (channels // 2 - 1)
    inv = np.exp(-inc * np.arange(channels // 2, dtype=np.float32))
    t = np.arange(length, dtype=np.float32)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1)


def audio_chunk_lengths(t_mel: int, n_window: int) -> List[int]:
    """HF chunking: n_window*2 mel frames per chunk, ragged tail."""
    chunk = n_window * 2
    n = -(-t_mel // chunk)
    lens = [chunk] * n
    if t_mel % chunk:
        lens[-1] = t_mel % chunk
    return lens


def audio_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    valid_len: torch.Tensor) -> torch.Tensor:
    """q, k, v [N, H, T, D]; the keys at or past valid_len[n] get -1e30.
    Products in the inputs' dtype, softmax in fp32."""
    T, D = q.shape[2], q.shape[3]
    logits = (q @ k.transpose(-1, -2)).float() / (D ** 0.5)
    keymask = torch.arange(T, device=q.device)[None, :] < valid_len[:, None]
    logits = torch.where(keymask[:, None, None, :], logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return probs @ v


class _AudioAttention(nn.Module):
    def __init__(self, C: int, heads: int, dtype, device=None):
        super().__init__()
        self.heads = heads
        kw = dict(dtype=dtype, device=device)
        self.q_proj = nn.Linear(C, C, **kw)
        self.k_proj = nn.Linear(C, C, bias=False, **kw)
        self.v_proj = nn.Linear(C, C, **kw)
        self.out_proj = nn.Linear(C, C, **kw)

    def forward(self, x, valid_len):
        N, T, C = x.shape
        H = self.heads
        split = lambda t: t.reshape(N, T, H, C // H).transpose(1, 2)
        out = audio_attention(split(self.q_proj(x)), split(self.k_proj(x)),
                              split(self.v_proj(x)), valid_len)
        return self.out_proj(out.transpose(1, 2).reshape(N, T, C))


class _AudioEncoderLayer(nn.Module):
    def __init__(self, cfg: OmniAudioConfig, device=None):
        super().__init__()
        kw = dict(dtype=cfg.dtype, device=device)
        self.self_attn_layer_norm = LayerNorm(cfg.d_model, device=device)
        self.self_attn = _AudioAttention(cfg.d_model, cfg.num_heads, cfg.dtype, device)
        self.final_layer_norm = LayerNorm(cfg.d_model, device=device)
        self.fc1 = nn.Linear(cfg.d_model, cfg.ffn_dim, **kw)
        self.fc2 = nn.Linear(cfg.ffn_dim, cfg.d_model, **kw)

    def forward(self, x, valid_len):
        x = x + self.self_attn(self.self_attn_layer_norm(x), valid_len)
        return x + self.fc2(_gelu(self.fc1(self.final_layer_norm(x))))


class OmniAudioEncoder(nn.Module):
    """forward(chunks [N, Lm, mel_bins], mel_lens [N], gather_idx [T_total])
    -> [T_total // 2, output_dim]: chunks are n_window*2-frame mel slices of
    one audio (the ragged tail zero-padded), gather_idx the valid post-conv
    tokens of the flattened [N * La] sequence in order (host-computed)."""

    def __init__(self, cfg: OmniAudioConfig, device=None):
        super().__init__()
        self.config = cfg
        kw = dict(dtype=cfg.dtype, device=device)
        self.conv1 = nn.Conv1d(cfg.num_mel_bins, cfg.d_model, 3, padding=1, **kw)
        self.conv2 = nn.Conv1d(cfg.d_model, cfg.d_model, 3, stride=2, padding=1, **kw)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", _AudioEncoderLayer(cfg, device))
        self.ln_post = LayerNorm(cfg.d_model, device=device)
        self.proj = nn.Linear(cfg.d_model, cfg.output_dim, **kw)
        self.register_buffer("positions", torch.tensor(
            sinusoid_positions(cfg.max_positions, cfg.d_model), device=device), persistent=False)

    def forward(self, chunks, mel_lens, gather_idx):
        cfg = self.config
        x = chunks.to(cfg.dtype).transpose(1, 2)                       # [N, mel, Lm]
        N, _, Lm = x.shape
        x = _gelu(self.conv1(x))
        melmask = torch.arange(Lm, device=x.device)[None, :] < mel_lens[:, None]
        x = x * melmask[:, None, :].to(x.dtype)
        x = _gelu(self.conv2(x)).transpose(1, 2)                       # [N, La, d]
        La = x.shape[1]
        x = x + self.positions[:La][None].to(x.dtype)
        after_lens = (mel_lens - 1) // 2 + 1
        for i in range(cfg.num_layers):
            x = getattr(self, f"layer_{i}")(x, after_lens)
        valid = x.reshape(N * La, cfg.d_model)[gather_idx.long()]
        T2 = valid.shape[0] // 2
        pooled = valid[: T2 * 2].reshape(T2, 2, cfg.d_model).mean(dim=1)
        return self.proj(self.ln_post(pooled))


def encode_audio_host(enc: OmniAudioEncoder, mel: np.ndarray) -> torch.Tensor:
    """mel [T_mel, mel_bins] -> [n_tokens, output_dim] on the encoder's
    device; the host chunks the mel and indexes the valid post-conv tokens."""
    cfg, dev = enc.config, enc.conv1.weight.device
    mel = np.asarray(mel, np.float32)
    lens = audio_chunk_lengths(int(mel.shape[0]), cfg.n_window)
    chunk = cfg.n_window * 2
    chunks = np.zeros((len(lens), chunk, cfg.num_mel_bins), np.float32)
    off = 0
    for i, ln in enumerate(lens):
        chunks[i, :ln] = mel[off: off + ln]
        off += ln
    la = (chunk - 1) // 2 + 1
    after = [(ln - 1) // 2 + 1 for ln in lens]
    gather = np.concatenate([np.arange(a) + i * la for i, a in enumerate(after)])
    with torch.inference_mode():
        return enc(torch.from_numpy(chunks).to(dev), torch.tensor(lens, device=dev),
                   torch.from_numpy(gather).to(dev))


# ----------------------------------------------------------- vision tower

def patchify_image(img: np.ndarray, cfg: OmniVisionConfig
                   ) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """HWC image (already resized so H, W % (patch*merge) == 0, normalized)
    -> (patch vectors [S, C*tp*p*p] in the HF processor's order, grid_thw).
    A single image is repeated temporal_patch_size times."""
    p, m, tp = cfg.patch_size, cfg.spatial_merge_size, cfg.temporal_patch_size
    H, W, C = img.shape
    gh, gw = H // p, W // p
    x = np.repeat(img.transpose(2, 0, 1)[None], tp, axis=0)  # [tp, C, H, W]
    x = x.reshape(1, tp, C, gh // m, m, p, gw // m, m, p)
    x = x.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    return (x.reshape(gh * gw, C * tp * p * p).astype(np.float32), (1, gh, gw))


def patchify_video(frames: np.ndarray, cfg: OmniVisionConfig
                   ) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """[F, H, W, C] frames -> (patch vectors, grid_thw); F padded up to a
    temporal_patch_size multiple by repeating the last frame."""
    p, m, tp = cfg.patch_size, cfg.spatial_merge_size, cfg.temporal_patch_size
    F_, H, W, C = frames.shape
    if F_ % tp:
        frames = np.concatenate([frames, np.repeat(frames[-1:], tp - F_ % tp, axis=0)], axis=0)
        F_ = frames.shape[0]
    gt, gh, gw = F_ // tp, H // p, W // p
    x = frames.transpose(0, 3, 1, 2).reshape(gt, tp, C, H, W)
    x = x.reshape(gt, tp, C, gh // m, m, p, gw // m, m, p)
    x = x.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    return (x.reshape(gt * gh * gw, C * tp * p * p).astype(np.float32), (gt, gh, gw))


def vision_window_meta(grid_thw: Tuple[int, int, int], cfg: OmniVisionConfig):
    """Qwen2_5OmniVisionEncoder.{rot_pos_emb,get_window_index} for one image
    or video: (window_index [S/4], seg_window [S], seg_full [S],
    rot [S, head_dim/2] fp32, order [S]), with the tokens already in window
    order for seg and rot."""
    t, h, w = grid_thw
    m = cfg.spatial_merge_size
    llm_h, llm_w = h // m, w // m
    hpos = np.arange(h).reshape(h // m, m, 1, 1)
    hpos = np.broadcast_to(hpos, (h // m, m, w // m, m))
    hpos = hpos.transpose(0, 2, 1, 3).reshape(-1)
    wpos = np.arange(w).reshape(1, 1, w // m, m)
    wpos = np.broadcast_to(wpos, (h // m, m, w // m, m))
    wpos = wpos.transpose(0, 2, 1, 3).reshape(-1)
    pos_ids = np.tile(np.stack([hpos, wpos], axis=-1), (t, 1))  # [S, 2]
    dim = cfg.head_dim // 2 // 2
    inv = 1.0 / (10000.0 ** (np.arange(0, dim, dtype=np.float32) / dim))
    max_grid = max(h, w)
    freq_table = np.outer(np.arange(max_grid, dtype=np.float32), inv)
    rot = freq_table[pos_ids].reshape(pos_ids.shape[0], -1)  # [S, hd/2]

    vit_win = cfg.window_size // m // cfg.patch_size
    idx = np.arange(t * llm_h * llm_w).reshape(t, llm_h, llm_w)
    pad_h = (-llm_h) % vit_win
    pad_w = (-llm_w) % vit_win
    nwh, nww = (llm_h + pad_h) // vit_win, (llm_w + pad_w) // vit_win
    padded = np.full((t, llm_h + pad_h, llm_w + pad_w), -100, np.int64)
    padded[:, :llm_h, :llm_w] = idx
    padded = padded.reshape(t, nwh, vit_win, nww, vit_win)
    padded = padded.transpose(0, 1, 3, 2, 4).reshape(t, nwh * nww, vit_win, vit_win)
    seqlens = (padded != -100).sum(axis=(2, 3)).reshape(-1)
    flat = padded.reshape(-1)
    window_index = flat[flat != -100]

    unit = m * m
    seg_window = np.repeat(np.arange(len(seqlens)), seqlens * unit)
    # one full-attention segment per temporal grid (HF cu_seqlens)
    seg_full = np.repeat(np.arange(t), h * w)

    order = np.repeat(window_index * unit, unit) + np.tile(np.arange(unit), len(window_index))
    rot_ordered = rot[order]
    seg_full_ordered = seg_full[order]
    return (window_index.astype(np.int32), seg_window.astype(np.int32),
            seg_full_ordered.astype(np.int32), rot_ordered.astype(np.float32),
            order.astype(np.int32))


def vision_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     seg: torch.Tensor) -> torch.Tensor:
    """q, k, v [S, H, D]; a query attends to the keys of its own segment
    (-1e30 elsewhere). Products in the inputs' dtype, softmax in fp32."""
    D = q.shape[-1]
    logits = torch.einsum("shd,zhd->hsz", q, k).float() / (D ** 0.5)
    mask = seg[:, None] == seg[None, :]
    logits = torch.where(mask[None], logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("hsz,zhd->shd", probs, v)


class _VisionAttention(nn.Module):
    def __init__(self, cfg: OmniVisionConfig, device=None):
        super().__init__()
        self.cfg = cfg
        C, kw = cfg.hidden_size, dict(dtype=cfg.dtype, device=device)
        self.q = nn.Linear(C, C, **kw)
        self.k = nn.Linear(C, C, **kw)
        self.v = nn.Linear(C, C, **kw)
        self.proj = nn.Linear(C, C, **kw)

    def forward(self, x, cos2, sin2, seg):
        c = self.cfg
        S, C = x.shape
        H, D = c.num_heads, c.head_dim
        q, k, v = (lin(x).reshape(S, H, D) for lin in (self.q, self.k, self.v))

        def rope(t):
            tf = t.float()
            d2 = D // 2
            rh = torch.cat([-tf[..., d2:], tf[..., :d2]], dim=-1)
            return (tf * cos2 + rh * sin2).to(t.dtype)

        out = vision_attention(rope(q), rope(k), v, seg)
        return self.proj(out.reshape(S, C))


class _VisionBlock(nn.Module):
    def __init__(self, cfg: OmniVisionConfig, device=None):
        super().__init__()
        C, kw = cfg.hidden_size, dict(dtype=cfg.dtype, device=device)
        self.norm1 = nn.Parameter(torch.ones(C, dtype=torch.float32, device=device))
        self.norm2 = nn.Parameter(torch.ones(C, dtype=torch.float32, device=device))
        self.attn = _VisionAttention(cfg, device)
        self.mlp_gate = nn.Linear(C, cfg.intermediate_size, **kw)
        self.mlp_up = nn.Linear(C, cfg.intermediate_size, **kw)
        self.mlp_down = nn.Linear(cfg.intermediate_size, C, **kw)

    def forward(self, x, cos2, sin2, seg):
        x = x + self.attn(rms_norm(x, self.norm1, 1e-6), cos2, sin2, seg)
        h = rms_norm(x, self.norm2, 1e-6)
        return x + self.mlp_down(F.silu(self.mlp_gate(h)) * self.mlp_up(h))


class OmniVisionEncoder(nn.Module):
    """forward(patches [S, C*tp*p*p] in window order, rot [S, hd/2],
    seg_window [S], seg_full [S]) -> merged tokens [S/4, out] in window
    order (the host applies the reverse permutation)."""

    def __init__(self, cfg: OmniVisionConfig, device=None):
        super().__init__()
        self.config = cfg
        C, kw = cfg.hidden_size, dict(dtype=cfg.dtype, device=device)
        unit = cfg.spatial_merge_size ** 2
        patch = cfg.in_channels * cfg.temporal_patch_size * cfg.patch_size ** 2
        self.patch_embed = nn.Linear(patch, C, bias=False, **kw)
        for i in range(cfg.depth):
            self.add_module(f"block_{i}", _VisionBlock(cfg, device))
        self.ln_q = nn.Parameter(torch.ones(C, dtype=torch.float32, device=device))
        self.merge_fc1 = nn.Linear(unit * C, unit * C, **kw)
        self.merge_fc2 = nn.Linear(unit * C, cfg.out_hidden_size, **kw)

    def forward(self, patches, rot, seg_window, seg_full):
        cfg = self.config
        x = self.patch_embed(patches.to(cfg.dtype))
        cos, sin = torch.cos(rot), torch.sin(rot)
        cos2 = torch.cat([cos, cos], dim=-1)[:, None, :]
        sin2 = torch.cat([sin, sin], dim=-1)[:, None, :]
        for i in range(cfg.depth):
            seg = seg_full if i in cfg.fullatt_block_indexes else seg_window
            x = getattr(self, f"block_{i}")(x, cos2, sin2, seg)
        x = rms_norm(x, self.ln_q, 1e-6)
        unit = cfg.spatial_merge_size ** 2
        x = x.reshape(x.shape[0] // unit, unit * cfg.hidden_size)
        return self.merge_fc2(_gelu(self.merge_fc1(x)))


def encode_vision_host(enc: OmniVisionEncoder, patches: np.ndarray,
                       grid_thw: Tuple[int, int, int]) -> torch.Tensor:
    """patches [S, ...] in the HF processor's order -> [S/4, out] in the
    original (pre-window) merged-token order."""
    dev = enc.patch_embed.weight.device
    window_index, seg_w, seg_f, rot, order = vision_window_meta(grid_thw, enc.config)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    with torch.inference_mode():
        out = enc(to(patches[order]), to(rot), to(seg_w), to(seg_f))
    return out[to(np.argsort(window_index))]


# ------------------------------------------------- 3-D positions (m-RoPE)

@dataclasses.dataclass
class MMSegment:
    """One span of the thinker input: kind in {'text','image','video',
    'audio'}; n_tokens for text/audio; grid_thw (+ seconds per temporal
    grid) for vision."""
    kind: str
    n_tokens: int = 0
    grid_thw: Optional[Tuple[int, int, int]] = None
    second_per_grid: float = 1.0


def build_mrope_positions(segments: Sequence[MMSegment], spatial_merge_size: int = 2,
                          position_id_per_seconds: int = 25) -> np.ndarray:
    """Qwen2_5Omni get_rope_index's positions over an explicit segment list:
    text and audio advance the three streams together; vision spans get
    (t*k, h, w) grids offset by the running max + 1. Returns [3, T]."""
    out = []
    st_idx = 0
    for seg in segments:
        if seg.kind in ("text", "audio"):
            n = seg.n_tokens
            pos = np.arange(n)[None].repeat(3, 0) + st_idx
        elif seg.kind in ("image", "video"):
            t, h, w = seg.grid_thw
            lh, lw = h // spatial_merge_size, w // spatial_merge_size
            t_index = (np.arange(t) * seg.second_per_grid *
                       position_id_per_seconds).astype(np.int64)
            tt = np.repeat(t_index, lh * lw)
            hh = np.tile(np.repeat(np.arange(lh), lw), t)
            ww = np.tile(np.arange(lw), t * lh)
            pos = np.stack([tt, hh, ww]) + st_idx
        else:
            raise ValueError(seg.kind)
        out.append(pos)
        st_idx = int(pos.max()) + 1
    return np.concatenate(out, axis=1)


# ----------------------------------------------------------------- thinker

AUDIO_PLACEHOLDER = "<AUDIO-Placeholder>"
IMAGE_PLACEHOLDER = "<IMAGE-Placeholder>"
VIDEO_PLACEHOLDER = "<VIDEO-Placeholder>"


class QwenOmniThinker:
    """The towers and the Qwen2 decoder on one device: text from any mix of
    text, audio, image and video. ``chat`` splices the towers' tokens at the
    placeholders and decodes greedily with 3-D m-RoPE positions."""

    def __init__(self, llm: L.LlamaForCausalLM, tokenizer,
                 audio_enc: Optional[OmniAudioEncoder] = None,
                 vision_enc: Optional[OmniVisionEncoder] = None,
                 max_new_tokens: int = 512):
        self.llm = llm
        self.tokenizer = tokenizer
        self.audio_enc = audio_enc
        self.vision_enc = vision_enc
        self.max_new_tokens = max_new_tokens

    @property
    def device(self) -> torch.device:
        return self.llm.device

    def encode_audio(self, mel: np.ndarray) -> torch.Tensor:
        assert self.audio_enc is not None, "no audio tower loaded"
        return encode_audio_host(self.audio_enc, mel)

    def encode_image(self, image: np.ndarray):
        assert self.vision_enc is not None, "no vision tower loaded"
        patches, grid = patchify_image(np.asarray(image, np.float32), self.vision_enc.config)
        return encode_vision_host(self.vision_enc, patches, grid), grid

    def encode_video(self, frames: np.ndarray):
        assert self.vision_enc is not None, "no vision tower loaded"
        patches, grid = patchify_video(np.asarray(frames, np.float32), self.vision_enc.config)
        return encode_vision_host(self.vision_enc, patches, grid), grid

    def embed_ids(self, ids: Sequence[int]) -> torch.Tensor:
        """[n] thinker-vocabulary ids -> [n, H] in the decoder's dtype."""
        with torch.inference_mode():
            return self.llm.embed(torch.tensor([list(ids)], dtype=torch.long,
                                               device=self.device))[0]

    def prepare(self, prompt: str, audios=None, images=None, videos=None):
        """(embeds [1, T, H], positions [3, 1, T] int32 numpy, segments):
        the prompt's text spans embedded and each placeholder replaced, in
        order, by its input's tower tokens. A placeholder without an input,
        or an input without a placeholder, raises."""
        segments: List[torch.Tensor] = []
        mm_segments: List[MMSegment] = []
        merge = self.vision_enc.config.spatial_merge_size if self.vision_enc is not None else 2
        queues: Dict[str, list] = {
            AUDIO_PLACEHOLDER: list(audios or []),
            IMAGE_PLACEHOLDER: list(images or []),
            VIDEO_PLACEHOLDER: list(videos or []),
        }
        parts = re.split("({}|{}|{})".format(AUDIO_PLACEHOLDER, IMAGE_PLACEHOLDER,
                                             VIDEO_PLACEHOLDER), prompt)
        for part in parts:
            if part in queues:
                if not queues[part]:
                    raise ValueError(f"prompt has {part} but no matching input was provided")
                item = queues[part].pop(0)
                if part == AUDIO_PLACEHOLDER:
                    emb = self.encode_audio(item)
                    mm_segments.append(MMSegment("audio", emb.shape[0]))
                elif part == IMAGE_PLACEHOLDER:
                    emb, grid = self.encode_image(item)
                    mm_segments.append(MMSegment("image", grid_thw=grid))
                else:
                    emb, grid = self.encode_video(item)
                    mm_segments.append(MMSegment("video", grid_thw=grid))
                segments.append(emb.to(self.llm.config.dtype))
            elif part:
                ids = self.tokenizer(part, add_special_tokens=False).input_ids
                if ids:
                    segments.append(self.embed_ids(ids))
                    mm_segments.append(MMSegment("text", len(ids)))
        for marker, q in queues.items():
            if q:
                raise ValueError(
                    f"{len(q)} {marker.strip('<>')} input(s) provided but the prompt has no "
                    f"{marker} marker — refusing to silently drop multimodal inputs")
        embeds = torch.cat(segments, dim=0)[None]
        positions = build_mrope_positions(mm_segments, merge)[:, None, :].astype(np.int32)
        return embeds, positions, mm_segments

    def chat(self, prompt: str, audios: Optional[Sequence[np.ndarray]] = None,
             images: Optional[Sequence[np.ndarray]] = None,
             videos: Optional[Sequence[np.ndarray]] = None,
             return_talker_streams: bool = False):
        """Greedy text reply. With return_talker_streams, also the talker's
        conditioning streams as the reference captures them: ``prompt_stream``
        [T, H] = last-layer hidden + token embeds (embeds zeroed at the
        multimodal positions), ``reply_stream`` [n, H] = hidden + embed of
        each fed-back token, and ``positions`` [3, 1, T]; fp32 numpy."""
        embeds, positions, mm_segments = self.prepare(prompt, audios, images, videos)
        if not return_talker_streams:
            return self._decode(embeds, positions)
        text, prompt_hidden, reply_rows = self._decode(embeds, positions, capture=True)
        merge = self.vision_enc.config.spatial_merge_size if self.vision_enc is not None else 2
        zeroed, off = embeds[0].float().cpu().numpy().copy(), 0
        for seg in mm_segments:
            if seg.kind in ("text", "audio"):
                n = seg.n_tokens
            else:
                t, h, w = seg.grid_thw
                n = t * (h // merge) * (w // merge)
            if seg.kind != "text":
                zeroed[off:off + n] = 0.0
            off += n
        streams = {"prompt_stream": prompt_hidden + zeroed, "reply_stream": reply_rows,
                   "positions": positions}
        return text, streams

    def prefill(self, embeds: torch.Tensor, positions: np.ndarray, max_new: int):
        """(logits of the last row [1, V], final hidden [1, T, H], cache):
        the prompt through the decoder with a KV cache of T + max_new rows,
        the flash kernel over the cache (kv_len T, q_offset 0)."""
        cfg, dev = self.llm.config, self.device
        T = embeds.shape[1]
        cache = L.init_kv_cache(cfg, 1, T + max_new, device=dev)
        with torch.inference_mode():
            logits, final, cache = self.llm.call_with_final(
                embeds, positions=torch.from_numpy(positions).to(dev), kv_write_index=0,
                kv_cache=cache, kv_len=torch.tensor([T], dtype=torch.int32, device=dev))
        return logits[:, -1], final, cache

    def _decode(self, embeds, positions, capture: bool = False):
        """Greedy decode: the prefill, then up to max_new_tokens single-token
        steps at positions max + 1, max + 2, ... on all three streams. The
        reference decodes every step and cuts the text at EOS; the steps
        after an EOS change neither the text nor the rows kept, so this loop
        stops there. capture=True also returns the prompt's final hidden
        rows [T, H] and the reply rows [n, H] (final hidden + embed of each
        fed-back token), fp32 numpy."""
        T = embeds.shape[1]
        eos = getattr(self.tokenizer, "eos_token_id", None)
        max_new = self.max_new_tokens
        dev = self.device
        logits, prompt_hidden, cache = self.prefill(embeds, positions, max_new)
        out = [int(logits.argmax(-1)[0])]
        rows: List[torch.Tensor] = []
        nxt_pos = int(positions.max()) + 1
        with torch.inference_mode():
            for i in range(max_new):
                if eos is not None and out[-1] == eos:
                    break
                emb = self.llm.embed(torch.tensor([[out[-1]]], dtype=torch.long, device=dev))
                pos = torch.full((3, 1, 1), nxt_pos + i, dtype=torch.int32, device=dev)
                logits, final, cache = self.llm.call_with_final(
                    emb, positions=pos, kv_write_index=T + i, kv_cache=cache,
                    kv_len=torch.tensor([T + i + 1], dtype=torch.int32, device=dev))
                out.append(int(logits[:, -1].argmax(-1)[0]))
                if capture:
                    rows.append((final[0, 0] + emb[0, 0]).float())
        if eos is not None and eos in out:
            out = out[: out.index(eos)]
        text = self.tokenizer.decode(out)
        if not capture:
            return text
        H = self.llm.config.hidden_size
        reply = (torch.stack(rows[:len(out)]).cpu().numpy() if rows[:len(out)]
                 else np.zeros((0, H), np.float32))
        return text, prompt_hidden[0].float().cpu().numpy(), reply


# ---------------------------------------------------------------- builders

def unit_norms_(module: nn.Module) -> nn.Module:
    """The vision tower's raw RMSNorm scales (``norm1``, ``norm2``, ``ln_q``)
    set to 1, as a random init leaves them N(0, scale)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.rsplit(".", 1)[-1] in ("norm1", "norm2", "ln_q"):
                p.fill_(1.0)
    return module


def omni_thinker_configs(dtype: torch.dtype = torch.bfloat16, stated: Optional[Dict] = None):
    """(audio, vision, llm) configs of Qwen2.5-Omni-7B in `dtype`; `stated`
    replaces preset fields part by part ({'audio': {...}, 'vision': {...},
    'llm': {...}}, as ``convert.read_omni_config`` reads them), the vision
    tower's full-attention blocks kept below its depth."""
    stated = stated or {}
    audio = dataclasses.replace(omni_audio_full(), dtype=dtype, **stated.get("audio", {}))
    vision = dataclasses.replace(omni_vision_full(), dtype=dtype, **stated.get("vision", {}))
    vision = dataclasses.replace(vision, fullatt_block_indexes=tuple(
        i for i in vision.fullatt_block_indexes if i < vision.depth))
    llm = dataclasses.replace(thinker_llm_full(), dtype=dtype, param_dtype=dtype,
                              **stated.get("llm", {}))
    return audio, vision, llm


def build_tiny_omni_thinker(tokenizer=None, *, device="cpu", seed: int = 0) -> QwenOmniThinker:
    """Test-scale thinker with both towers, random from `seed` (fp32)."""
    from spider_tpu_torch.models.factory import random_init_
    from spider_tpu_torch.models.tokenizer import TinyTokenizer

    tokenizer = tokenizer or TinyTokenizer()
    gen = torch.Generator(device=device).manual_seed(seed)
    lcfg = dataclasses.replace(thinker_tiny_llm(), vocab_size=max(len(tokenizer), 512))
    llm = random_init_(L.LlamaForCausalLM(lcfg, device).eval(), gen)
    audio = random_init_(OmniAudioEncoder(dataclasses.replace(
        omni_audio_tiny(), output_dim=lcfg.hidden_size), device).eval(), gen)
    vision = unit_norms_(random_init_(OmniVisionEncoder(dataclasses.replace(
        omni_vision_tiny(), out_hidden_size=lcfg.hidden_size), device).eval(), gen))
    return QwenOmniThinker(llm, tokenizer, audio, vision, max_new_tokens=16)


def build_full_omni_thinker(ckpt_path: Optional[str] = None, *, device="cuda",
                            dtype: torch.dtype = torch.bfloat16, max_new_tokens: int = 512,
                            seed: int = 0) -> QwenOmniThinker:
    """Qwen2.5-Omni-7B's thinker in `dtype` on `device`. With ckpt_path, the
    HF checkpoint's thinker (bare or ``thinker.``-prefixed keys) streamed
    through ``convert.omni_thinker_rules``, its widths and depths from its
    config.json where it has one (``convert.read_omni_config``), its tokenizer through
    ``factory._hf_tokenizer``; otherwise random from `seed` with
    TinyTokenizer."""
    from spider_tpu_torch.models import convert as C
    from spider_tpu_torch.models.factory import _hf_tokenizer, random_init_
    from spider_tpu_torch.models.tokenizer import TinyTokenizer

    acfg, vcfg, lcfg = omni_thinker_configs(dtype, C.read_omni_config(ckpt_path))
    audio = OmniAudioEncoder(acfg, device).eval()
    vision = OmniVisionEncoder(vcfg, device).eval()
    llm = L.LlamaForCausalLM(lcfg, device).eval()
    if ckpt_path:
        C.load_omni_thinker(ckpt_path, audio, vision, llm)
        tokenizer = _hf_tokenizer(ckpt_path, "")
    else:
        gen = torch.Generator(device=device).manual_seed(seed)
        for mod in (llm, audio, vision):
            random_init_(mod, gen)
        unit_norms_(vision)
        tokenizer = TinyTokenizer()
    return QwenOmniThinker(llm, tokenizer, audio, vision, max_new_tokens=max_new_tokens)


def build_omni_thinker_chat_fn(ckpt_path: Optional[str] = None, *, device="cuda"):
    """Chat function of the infer twin: the full-size thinker from a
    checkpoint when a path is given, the tiny random one otherwise."""
    thinker = (build_full_omni_thinker(ckpt_path, device=device) if ckpt_path
               else build_tiny_omni_thinker(device=device))

    def chat_fn(prompt: str, audios=None, images=None, videos=None) -> str:
        return thinker.chat(prompt, audios=audios, images=images, videos=videos)

    return chat_fn
