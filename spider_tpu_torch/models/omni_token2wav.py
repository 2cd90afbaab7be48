"""Qwen2.5-Omni token2wav in PyTorch (counterpart of
spider_tpu/models/omni_token2wav.py): speech-codec tokens -> waveform.

  * DiT flow-matching mel generator: the codec-token embedding (each repeated
    ``repeats`` times), an ECAPA-TDNN speaker encoder over a reference mel
    (reflect padding, Res2Net, squeeze-excitation, attentive statistics
    pooling), AdaLN-Zero layers with block-local attention (blocks of
    ``block_size`` frames, one block of look-ahead or look-back in the
    layers named by the config) and interleaved rotary on the first head
    only, tanh GELU; ``dit_sample`` integrates it with RK4 (Kutta's 3/8
    rule) over the sway-warped time grid, with classifier-free guidance by
    doubling the batch.
  * BigVGAN vocoder: log-mel -> dB -> [-1, 1], the conv stem, transposed
    convolutions (``ops/convs.py::ConvTranspose1dTorch``, torch's semantics,
    which the reference's own ``ConvTranspose1dTorch`` emulates; ROADMAP C14
    does not arise here), anti-aliased SnakeBeta activations (fixed
    Kaiser-sinc filters, 2x up and down with replicate padding) and AMP
    residual blocks.

The reference computes token2wav in fp32 (``dit_full`` and ``bigvgan_full``
keep dtype float32), and so does the port. The DiT's attention stays plain
PyTorch with its block mask (``dit_attention``), as the reference's einsum
does. Activations are [B, T, C] between modules as in the JAX code; the
convolutions run in torch's [B, C, T]. Submodule names follow the JAX tree.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from spider_tpu_torch.ops.convs import ConvTranspose1dTorch


# ----------------------------------------------------------------- configs

@dataclasses.dataclass(frozen=True)
class DiTConfig:
    mel_dim: int = 80
    num_embeds: int = 8193
    emb_dim: int = 512
    hidden_size: int = 1024
    num_hidden_layers: int = 22
    num_attention_heads: int = 16
    head_dim: int = 64
    ff_mult: int = 2
    block_size: int = 24
    look_ahead_layers: Tuple[int, ...] = (10,)
    look_backward_layers: Tuple[int, ...] = (0, 20)
    repeats: int = 2
    # ECAPA speaker encoder
    enc_dim: int = 128
    enc_emb_dim: int = 192
    enc_channels: Tuple[int, ...] = (256, 256, 256, 256, 768)
    enc_kernel_sizes: Tuple[int, ...] = (5, 3, 3, 3, 1)
    enc_dilations: Tuple[int, ...] = (1, 2, 3, 4, 1)
    enc_attention_channels: int = 64
    enc_res2net_scale: int = 2
    enc_se_channels: int = 64
    dtype: torch.dtype = torch.float32


@dataclasses.dataclass(frozen=True)
class BigVGANConfig:
    mel_dim: int = 80
    upsample_initial_channel: int = 1536
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5),) * 3
    upsample_rates: Tuple[int, ...] = (5, 3, 2, 2, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (11, 7, 4, 4, 4, 4)
    dtype: torch.dtype = torch.float32


def dit_full() -> DiTConfig:
    return DiTConfig()


def bigvgan_full() -> BigVGANConfig:
    return BigVGANConfig()


def dit_tiny() -> DiTConfig:
    return DiTConfig(mel_dim=8, num_embeds=16, emb_dim=12, hidden_size=32, num_hidden_layers=3,
                     num_attention_heads=2, head_dim=16, block_size=4, look_ahead_layers=(1,),
                     look_backward_layers=(0, 2), enc_channels=(8, 8, 8, 8, 24), enc_dim=12,
                     enc_emb_dim=6, enc_attention_channels=4, enc_res2net_scale=2,
                     enc_se_channels=4)


def bigvgan_tiny() -> BigVGANConfig:
    return BigVGANConfig(mel_dim=8, upsample_initial_channel=16, resblock_kernel_sizes=(3,),
                         resblock_dilation_sizes=((1, 3, 5),), upsample_rates=(2, 2),
                         upsample_kernel_sizes=(4, 4))


# ------------------------------------------------- ECAPA speaker encoder

class TDNNBlock(nn.Module):
    """Conv1d('same' by reflect padding) + ReLU (TimeDelayNetBlock), [B, T, C]."""

    def __init__(self, cin: int, cout: int, kernel_size: int, dilation: int = 1, dtype=None,
                 device=None):
        super().__init__()
        self.pad = (kernel_size - 1) * dilation // 2
        self.conv = nn.Conv1d(cin, cout, kernel_size, dilation=dilation, dtype=dtype,
                              device=device)

    def forward(self, x):
        h = x.transpose(1, 2)
        if self.pad:
            h = F.pad(h, (self.pad, self.pad), mode="reflect")
        return F.relu(self.conv(h)).transpose(1, 2)


class Res2NetBlock(nn.Module):
    def __init__(self, channels: int, scale: int, kernel_size: int, dilation: int, dtype,
                 device=None):
        super().__init__()
        self.scale = scale
        w = channels // scale
        for i in range(1, scale):
            self.add_module(f"block_{i - 1}", TDNNBlock(w, w, kernel_size, dilation, dtype,
                                                        device))

    def forward(self, x):
        parts = torch.chunk(x, self.scale, dim=-1)
        outs, prev = [], None
        for i, part in enumerate(parts):
            if i == 0:
                prev = part
            elif i == 1:
                prev = self.block_0(part)
            else:
                prev = getattr(self, f"block_{i - 1}")(part + prev)
            outs.append(prev)
        return torch.cat(outs, dim=-1)


class SEBlock(nn.Module):
    def __init__(self, channels: int, se_channels: int, dtype, device=None):
        super().__init__()
        self.conv1 = nn.Linear(channels, se_channels, dtype=dtype, device=device)
        self.conv2 = nn.Linear(se_channels, channels, dtype=dtype, device=device)

    def forward(self, x):
        s = F.relu(self.conv1(x.mean(dim=1, keepdim=True)))
        return x * torch.sigmoid(self.conv2(s))


class SERes2NetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, res2net_scale: int, se_channels: int,
                 kernel_size: int, dilation: int, dtype, device=None):
        super().__init__()
        self.tdnn1 = TDNNBlock(cin, cout, 1, 1, dtype, device)
        self.res2net_block = Res2NetBlock(cout, res2net_scale, kernel_size, dilation, dtype,
                                          device)
        self.tdnn2 = TDNNBlock(cout, cout, 1, 1, dtype, device)
        self.se_block = SEBlock(cout, se_channels, dtype, device)

    def forward(self, x):
        h = self.tdnn2(self.res2net_block(self.tdnn1(x)))
        return x + self.se_block(h)


class AttentiveStatsPooling(nn.Module):
    def __init__(self, channels: int, attention_channels: int, dtype, device=None,
                 eps: float = 1e-12):
        super().__init__()
        self.eps = eps
        self.tdnn = TDNNBlock(3 * channels, attention_channels, 1, 1, dtype, device)
        self.conv = nn.Linear(attention_channels, channels, dtype=dtype, device=device)

    def forward(self, x):
        # x [B, T, C]; full-length masks (the inference path: lengths == T)
        mean = x.mean(dim=1, keepdim=True)
        std = ((x - mean) ** 2).mean(dim=1, keepdim=True).clamp(min=self.eps).sqrt()
        attn = torch.cat([x, mean.expand_as(x), std.expand_as(x)], dim=-1)
        attn = self.conv(torch.tanh(self.tdnn(attn)))
        w = torch.softmax(attn, dim=1)
        mean = (w * x).sum(dim=1)
        std = (w * (x - mean[:, None]) ** 2).sum(dim=1).clamp(min=self.eps).sqrt()
        return torch.cat([mean, std], dim=-1)                      # [B, 2C]


class ECAPAEncoder(nn.Module):
    """ECAPA-TDNN speaker embedding of a reference mel [B, T, mel] -> [B, enc_dim]."""

    def __init__(self, cfg: DiTConfig, device=None):
        super().__init__()
        self.config = cfg
        ch, dt = cfg.enc_channels, cfg.dtype
        self.block_0 = TDNNBlock(cfg.mel_dim, ch[0], cfg.enc_kernel_sizes[0],
                                 cfg.enc_dilations[0], dt, device)
        for i in range(1, len(ch) - 1):
            self.add_module(f"block_{i}", SERes2NetBlock(
                ch[i - 1], ch[i], cfg.enc_res2net_scale, cfg.enc_se_channels,
                cfg.enc_kernel_sizes[i], cfg.enc_dilations[i], dt, device))
        self.mfa = TDNNBlock(sum(ch[1:-1]), ch[-1], cfg.enc_kernel_sizes[-1],
                             cfg.enc_dilations[-1], dt, device)
        self.asp = AttentiveStatsPooling(ch[-1], cfg.enc_attention_channels, dt, device)
        self.fc = nn.Linear(2 * ch[-1], cfg.enc_dim, dtype=dt, device=device)

    def forward(self, mel):
        n = len(self.config.enc_channels)
        h = self.block_0(mel)
        feats = []
        for i in range(1, n - 1):
            h = getattr(self, f"block_{i}")(h)
            feats.append(h)
        h = self.mfa(torch.cat(feats, dim=-1))
        return self.fc(self.asp(h))


# --------------------------------------------------------------------- DiT

def _timestep_embedding(t: torch.Tensor, dim: int = 256, scale: float = 1000.0):
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, device=t.device) / (half - 1))
    ang = scale * t[:, None].float() * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _rotate_interleaved(x):
    x = x.reshape(*x.shape[:-1], -1, 2)
    return torch.stack([-x[..., 1], x[..., 0]], dim=-1).flatten(-2)


def dit_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """q, k, v [B, H, T, D]; mask [T, T] True where a query sees a key
    (-inf elsewhere). Softmax in fp32."""
    D = q.shape[-1]
    logits = (q @ k.transpose(-1, -2)) / math.sqrt(D)
    logits = torch.where(mask[None, None], logits.float(),
                         torch.full((), float("-inf"), device=q.device))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return probs @ v


class DiTAttention(nn.Module):
    """Block-local attention; rotary on head 0 only (the HF quirk)."""

    def __init__(self, cfg: DiTConfig, look_ahead: int, look_backward: int, device=None):
        super().__init__()
        self.cfg, self.look_ahead, self.look_backward = cfg, look_ahead, look_backward
        C, HD, kw = cfg.hidden_size, cfg.num_attention_heads * cfg.head_dim, dict(
            dtype=cfg.dtype, device=device)
        self.to_q = nn.Linear(C, HD, **kw)
        self.to_k = nn.Linear(C, HD, **kw)
        self.to_v = nn.Linear(C, HD, **kw)
        self.to_out = nn.Linear(HD, C, **kw)

    def forward(self, x):
        cfg = self.cfg
        B, T, _ = x.shape
        H, D = cfg.num_attention_heads, cfg.head_dim
        q, k, v = (lin(x).reshape(B, T, H, D).transpose(1, 2)
                   for lin in (self.to_q, self.to_k, self.to_v))
        pos = torch.arange(T, device=x.device)
        inv = 1.0 / (10000.0 ** (torch.arange(0, D, 2, device=x.device) / D))
        f = pos[:, None] * inv[None, :]
        f = torch.stack([f, f], dim=-1).reshape(T, D)
        cos, sin = torch.cos(f), torch.sin(f)
        q0 = q[:, :1] * cos + _rotate_interleaved(q[:, :1]) * sin
        k0 = k[:, :1] * cos + _rotate_interleaved(k[:, :1]) * sin
        q = torch.cat([q0.to(q.dtype), q[:, 1:]], dim=1)
        k = torch.cat([k0.to(k.dtype), k[:, 1:]], dim=1)
        blk = pos // cfg.block_size
        diff = blk[None, :] - blk[:, None]
        mask = (diff >= -self.look_backward) & (diff <= self.look_ahead)
        out = dit_attention(q, k, v, mask)
        return self.to_out(out.transpose(1, 2).reshape(B, T, H * D))


def _plain_ln(x: torch.Tensor) -> torch.Tensor:
    """flax LayerNorm without scale or bias, eps 1e-6."""
    return F.layer_norm(x, x.shape[-1:], eps=1e-6)


class DiTLayer(nn.Module):
    def __init__(self, cfg: DiTConfig, look_ahead: int, look_backward: int, device=None):
        super().__init__()
        C, kw = cfg.hidden_size, dict(dtype=cfg.dtype, device=device)
        self.attn_norm_linear = nn.Linear(C, 6 * C, **kw)
        self.attn = DiTAttention(cfg, look_ahead, look_backward, device)
        self.ff_in = nn.Linear(C, C * cfg.ff_mult, **kw)
        self.ff_out = nn.Linear(C * cfg.ff_mult, C, **kw)

    def forward(self, x, temb):
        mod = self.attn_norm_linear(F.silu(temb))
        sh_msa, sc_msa, g_msa, sh_mlp, sc_mlp, g_mlp = torch.chunk(mod, 6, dim=-1)
        h = _plain_ln(x) * (1 + sc_msa[:, None]) + sh_msa[:, None]
        x = x + g_msa[:, None] * self.attn(h)
        h = _plain_ln(x) * (1 + sc_mlp[:, None]) + sh_mlp[:, None]
        h = self.ff_out(F.gelu(self.ff_in(h), approximate="tanh"))
        return x + g_mlp[:, None] * h


class DiTModel(nn.Module):
    """Velocity: (noisy mel [B, T, mel], speaker conditioning [B, T, enc_emb_dim],
    reference mel [B, T_ref, mel], codec codes [B, T / repeats], t) ->
    [B', T, mel]; B' = 2B with apply_cfg (conditioned, then unconditioned)."""

    def __init__(self, cfg: DiTConfig, device=None):
        super().__init__()
        self.config = cfg
        C, kw = cfg.hidden_size, dict(dtype=cfg.dtype, device=device)
        self.time_mlp_in = nn.Linear(256, C, **kw)
        self.time_mlp_out = nn.Linear(C, C, **kw)
        self.codec_embed = nn.Embedding(cfg.num_embeds + 1, cfg.emb_dim, **kw)
        self.spk_encoder = ECAPAEncoder(cfg, device)
        self.input_proj = nn.Linear(cfg.mel_dim + cfg.enc_dim + cfg.emb_dim + cfg.enc_emb_dim,
                                    C, **kw)
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"layer_{i}", DiTLayer(
                cfg, int(i in cfg.look_ahead_layers), int(i in cfg.look_backward_layers),
                device))
        self.norm_out_linear = nn.Linear(C, 2 * C, **kw)
        self.proj_out = nn.Linear(C, cfg.mel_dim, **kw)

    def forward(self, x, speaker_embedding, condition_mel, code, t, apply_cfg: bool = True,
                drop_audio_cond: bool = False, drop_code: bool = False):
        cfg = self.config
        B = x.shape[0]
        t = torch.as_tensor(t, dtype=cfg.dtype, device=x.device).reshape(-1).expand(B)
        temb = self.time_mlp_out(F.silu(self.time_mlp_in(_timestep_embedding(t).to(cfg.dtype))))
        code_in = code if not drop_code or apply_cfg else torch.zeros_like(code)
        code_embed = self.codec_embed(code_in).repeat_interleave(cfg.repeats, dim=1)
        if apply_cfg:
            code_uncond = self.codec_embed(torch.zeros_like(code)).repeat_interleave(
                cfg.repeats, dim=1)
            x = torch.cat([x, x])
            speaker_embedding = torch.cat([speaker_embedding,
                                           torch.zeros_like(speaker_embedding)])
            condition_mel = torch.cat([condition_mel, torch.zeros_like(condition_mel)])
            code_embed = torch.cat([code_embed, code_uncond])
            temb = torch.cat([temb, temb])
        elif drop_audio_cond:
            condition_mel = torch.zeros_like(condition_mel)
            speaker_embedding = torch.zeros_like(speaker_embedding)
        enc = self.spk_encoder(condition_mel)
        enc = enc[:, None].expand(x.shape[0], x.shape[1], cfg.enc_dim)
        h = self.input_proj(torch.cat([x, enc, code_embed, speaker_embedding], dim=-1))
        for i in range(cfg.num_hidden_layers):
            h = getattr(self, f"layer_{i}")(h, temb)
        scale, shift = torch.chunk(self.norm_out_linear(F.silu(temb)), 2, dim=-1)
        h = _plain_ln(h) * (1 + scale[:, None]) + shift[:, None]
        return self.proj_out(h)


def time_grid(num_steps: int, sway_coefficient: Optional[float] = -1.0) -> torch.Tensor:
    """The reference's grid: jnp.linspace(0, 1, num_steps) (i / (n - 1) in
    fp32, the last point 1 exactly), then the sway warp."""
    n = num_steps
    t = torch.cat([torch.arange(n - 1, dtype=torch.float32) / torch.tensor(n - 1.0),
                   torch.ones(1)]) if n > 1 else torch.zeros(1)
    if sway_coefficient is not None:
        t = t + sway_coefficient * (torch.cos(math.pi / 2 * t) - 1 + t)
    return t


def dit_sample(model: DiTModel, code: torch.Tensor, conditioning: torch.Tensor,
               reference_mel: torch.Tensor, generator: Optional[torch.Generator] = None,
               num_steps: int = 10, guidance_scale: float = 0.5,
               sway_coefficient: Optional[float] = -1.0,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RK4 (Kutta 3/8) flow integration -> mel [1, T_mel, mel_dim].

    code [1, N]; conditioning [1, enc_emb_dim]; reference_mel [1, T_ref,
    mel_dim]. The initial noise [1, N * repeats, mel_dim] is `noise` when
    given (a test injects the reference's draw), else drawn from
    `generator`."""
    cfg = model.config
    dev = model.proj_out.weight.device
    T = code.shape[1] * cfg.repeats
    y = (noise.to(dev, torch.float32) if noise is not None else
         torch.randn((1, T, cfg.mel_dim), generator=generator, device=dev))
    spk = conditioning[:, None].expand(1, T, conditioning.shape[-1])
    t_grid = time_grid(num_steps, sway_coefficient).to(dev)

    def vf(t, y):
        guided, null = torch.chunk(model(y, spk, reference_mel, code, t, apply_cfg=True), 2)
        return guided + (guided - null) * guidance_scale

    with torch.inference_mode():
        for i in range(num_steps - 1):
            t0, t1 = t_grid[i], t_grid[i + 1]
            h = t1 - t0
            k1 = vf(t0, y)
            k2 = vf(t0 + h / 3, y + h * k1 / 3)
            k3 = vf(t0 + 2 * h / 3, y + h * (k2 - k1 / 3))
            k4 = vf(t1, y + h * (k1 - k2 + k3))
            y = y + (k1 + 3 * (k2 + k3) + k4) * h / 8
    return y


# ----------------------------------------------------------------- BigVGAN

def _kaiser_sinc_filter(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4 * half_width
    a = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    win = np.kaiser(kernel_size, beta)
    if even:
        t = np.arange(-half_size, half_size) + 0.5
    else:
        t = np.arange(kernel_size) - half_size
    if cutoff == 0:
        return np.zeros((kernel_size,), np.float32)
    f = 2 * cutoff * win * np.sinc(2 * cutoff * t)
    return (f / f.sum()).astype(np.float32)


def _depthwise_filter(filt: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    C = x.shape[1]
    return torch.from_numpy(filt).to(x.device, x.dtype)[None, None].expand(C, 1, -1)


def _upsample1d(x: torch.Tensor, ratio: int = 2, kernel_size: int = 12) -> torch.Tensor:
    """x [B, C, T] -> [B, C, ratio * T]: replicate padding, a transposed
    depthwise convolution with the Kaiser-sinc filter (the reference's
    zero-stuffed correlation is the transposed convolution with the filter
    flipped), times the ratio, cropped."""
    K, s = kernel_size, ratio
    f = _kaiser_sinc_filter(0.5 / s, 0.6 / s, K)
    pad = K // s - 1
    x = F.pad(x, (pad, pad), mode="replicate")
    y = s * F.conv_transpose1d(x, _depthwise_filter(f[::-1].copy(), x), stride=s,
                               groups=x.shape[1])
    pad_left = pad * s + (K - s) // 2
    pad_right = pad * s + (K - s + 1) // 2
    return y[..., pad_left:y.shape[-1] - pad_right]


def _downsample1d(x: torch.Tensor, ratio: int = 2, kernel_size: int = 12) -> torch.Tensor:
    K = kernel_size
    f = _kaiser_sinc_filter(0.5 / ratio, 0.6 / ratio, K)
    even = K % 2 == 0
    x = F.pad(x, (K // 2 - int(even), K // 2), mode="replicate")
    return F.conv1d(x, _depthwise_filter(f, x), stride=ratio, groups=x.shape[1])


class SnakeBeta(nn.Module):
    """x + 1 / (exp(beta) + 1e-9) * sin^2(x * exp(alpha)), anti-aliased (2x up,
    the activation, 2x down), on [B, C, T]."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(channels, dtype=torch.float32, device=device))
        self.beta = nn.Parameter(torch.zeros(channels, dtype=torch.float32, device=device))

    def forward(self, x):
        x = _upsample1d(x)
        a, b = self.alpha[None, :, None], self.beta[None, :, None]
        x = x + (1.0 / (torch.exp(b) + 1e-9)) * torch.sin(x * torch.exp(a)) ** 2
        return _downsample1d(x)


class AMPBlock(nn.Module):
    def __init__(self, channels: int, kernel_size: int, dilations: Tuple[int, ...], dtype,
                 device=None):
        super().__init__()
        self.n = len(dilations)
        kw = dict(dtype=dtype, device=device)
        for i, d in enumerate(dilations):
            self.add_module(f"act1_{i}", SnakeBeta(channels, device))
            self.add_module(f"conv1_{i}", nn.Conv1d(channels, channels, kernel_size,
                                                    dilation=d, padding=(kernel_size - 1) * d // 2,
                                                    **kw))
            self.add_module(f"act2_{i}", SnakeBeta(channels, device))
            self.add_module(f"conv2_{i}", nn.Conv1d(channels, channels, kernel_size,
                                                    padding=(kernel_size - 1) // 2, **kw))

    def forward(self, x):
        for i in range(self.n):
            h = getattr(self, f"conv1_{i}")(getattr(self, f"act1_{i}")(x))
            x = x + getattr(self, f"conv2_{i}")(getattr(self, f"act2_{i}")(h))
        return x


class BigVGAN(nn.Module):
    """log-mel [B, T, mel] -> waveform [B, T * prod(upsample_rates)] in [-1, 1]."""

    def __init__(self, cfg: BigVGANConfig, device=None):
        super().__init__()
        self.config = cfg
        kw = dict(dtype=cfg.dtype, device=device)
        ch = cfg.upsample_initial_channel
        self.conv_pre = nn.Conv1d(cfg.mel_dim, ch, 7, padding=3, **kw)
        for i, (rate, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            self.add_module(f"up_{i}", ConvTranspose1dTorch(ch, ch // 2, k, rate, **kw))
            ch //= 2
            for j, (rk, ds) in enumerate(zip(cfg.resblock_kernel_sizes,
                                             cfg.resblock_dilation_sizes)):
                self.add_module(f"res_{i}_{j}", AMPBlock(ch, rk, tuple(ds), cfg.dtype, device))
        self.activation_post = SnakeBeta(ch, device)
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3, bias=False, **kw)

    def forward(self, mel):
        cfg = self.config
        amp = torch.exp(mel.to(cfg.dtype))
        min_level = math.exp(-115 / 20.0 * math.log(10))
        db = 20.0 * torch.log10(amp.clamp(min=min_level)) - 20.0
        x = (2.0 * ((db + 115.0) / 115.0) - 1.0).clamp(-1.0, 1.0).transpose(1, 2)
        x = self.conv_pre(x)
        R = len(cfg.resblock_kernel_sizes)
        for i in range(len(cfg.upsample_rates)):
            x = getattr(self, f"up_{i}")(x)
            acc = None
            for j in range(R):
                r = getattr(self, f"res_{i}_{j}")(x)
                acc = r if acc is None else acc + r
            x = acc / R
        x = self.conv_post(self.activation_post(x))
        return x[:, 0].clamp(-1.0, 1.0)


# ------------------------------------------------------------ full bundle

class OmniToken2Wav:
    """DiT mel generation + BigVGAN vocoding (Qwen2_5OmniToken2WavModel)."""

    def __init__(self, dit: DiTModel, vocoder: BigVGAN):
        self.dit = dit
        self.vocoder = vocoder

    def __call__(self, code, conditioning, reference_mel, num_steps: int = 10,
                 guidance_scale: float = 0.5, sway_coefficient: Optional[float] = -1.0,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None) -> np.ndarray:
        """code [1, N] ids; conditioning [1, enc_emb_dim]; reference_mel
        [1, T_ref, mel] (arrays or tensors) -> waveform [N * repeats * 240]
        as fp32 numpy (the full BigVGAN's 240x). An id without a codebook
        row raises here, before any index reaches the device (ROADMAP C15:
        the reference embeds it as NaN)."""
        dev = self.dit.proj_out.weight.device
        dt = self.dit.config.dtype
        ids = code.cpu().numpy() if torch.is_tensor(code) else np.asarray(code)
        rows = self.dit.config.num_embeds + 1
        if ids.size and (ids.min() < 0 or ids.max() >= rows):
            raise ValueError(f"codec ids {sorted(set(ids[(ids < 0) | (ids >= rows)].tolist()))} "
                             f"have no row in the DiT's codebook of {rows}")
        as_t = lambda a, d: torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                                            device=dev).to(d)
        mel = dit_sample(self.dit, as_t(code, torch.long), as_t(conditioning, dt),
                         as_t(reference_mel, dt), generator, num_steps=num_steps,
                         guidance_scale=guidance_scale, sway_coefficient=sway_coefficient,
                         noise=noise)
        with torch.inference_mode():
            return self.vocoder(mel)[0].float().cpu().numpy()


def build_tiny_token2wav(*, device="cpu", seed: int = 0) -> OmniToken2Wav:
    from spider_tpu_torch.models.factory import random_init_

    gen = torch.Generator(device=device).manual_seed(seed)
    dit = random_init_(DiTModel(dit_tiny(), device).eval(), gen)
    voc = random_init_(BigVGAN(bigvgan_tiny(), device).eval(), gen)
    return OmniToken2Wav(dit, voc)
