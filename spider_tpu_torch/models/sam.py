"""Segment Anything (counterpart of spider_tpu/models/sam.py): the ViT image
encoder with windowed attention, the prompt encoder (points, boxes, text
embeddings) and the two-way mask decoder behind the MASK decoder.

Spider trains only the mask decoder and prompts it with boxes (the
SpiderDecoder path: Grounding DINO's top box) or with text embeddings (the
MASK aligner's projection, in training). The encoder runs without a graph
in ``predict_box`` and ``predict_text``, where the reference stops its
gradient.

Numerics held to the reference: channels-last, the convolutions in NCHW;
LayerNorm's eps 1e-6 (flax's default); GELU the tanh form; the ViT blocks
are the einsum with SAM's decomposed relative positions (a window of 14
pads the 64x64 grid to 70, and the padded keys are not masked, as in the
reference); the mask decoder's attentions go through ``ops.attention.attention``,
so on the card they are the flash kernel (the prompt tokens' self-attention
at head dim 32, token-to-image and image-to-token at 16). The upscaling is
flax's ``nn.ConvTranspose``, which applies its kernel unflipped: as a torch
``ConvTranspose2d`` that is the kernel flipped in both spatial axes
(``convert.load_jax_params`` flips it). ``postprocess_masks`` resizes as
``jax.image.resize(..., "bilinear")`` does, antialiased when it shrinks.

Every layer computes in the config's dtype whatever its parameters' dtype
(flax's ``dtype`` beside ``param_dtype``), so the mask decoder can hold
fp32 parameters for its optimizer and still compute in bf16 beside a bf16
encoder. Names follow the JAX tree.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from spider_tpu_torch.ops.attention import attention


LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class SamConfig:
    img_size: int = 1024
    patch_size: int = 16
    encoder_width: int = 1280          # ViT-H
    encoder_layers: int = 32
    encoder_heads: int = 16
    encoder_global_attn_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    window_size: int = 14
    prompt_embed_dim: int = 256
    mask_in_chans: int = 16
    decoder_depth: int = 2
    decoder_heads: int = 8
    num_multimask_outputs: int = 3
    dtype: torch.dtype = torch.float32

    @property
    def embed_hw(self) -> int:
        return self.img_size // self.patch_size


def sam_vit_h() -> SamConfig:
    return SamConfig()


def sam_tiny() -> SamConfig:
    return SamConfig(img_size=64, patch_size=16, encoder_width=32, encoder_layers=2,
                     encoder_heads=2, encoder_global_attn_indexes=(1,), window_size=2,
                     prompt_embed_dim=16, mask_in_chans=4)


class Dense(nn.Linear):
    """nn.Linear computing in `dtype`, whatever its parameters' dtype."""

    def __init__(self, d_in: int, d_out: int, dtype, device=None, bias: bool = True):
        super().__init__(d_in, d_out, bias=bias, dtype=dtype, device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt))


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm(eps=1e-6) computing in `dtype`, whatever its parameters'."""

    def __init__(self, dim: int, dtype, device=None):
        super().__init__(dim, eps=LN_EPS, dtype=dtype, device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.layer_norm(x.to(dt), self.normalized_shape, self.weight.to(dt),
                            self.bias.to(dt), self.eps)


class ConvTranspose2x2(nn.ConvTranspose2d):
    """Stride-2, 2x2 transposed convolution on NHWC (flax's ``nn.ConvTranspose``
    with its kernel flipped), computing in `dtype`."""

    def __init__(self, d_in: int, d_out: int, dtype, device=None):
        super().__init__(d_in, d_out, 2, stride=2, dtype=dtype, device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        y = F.conv_transpose2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt),
                               self.bias.to(dt), stride=2)
        return y.permute(0, 2, 3, 1)


class SamViTBlock(nn.Module):
    """A ViT block over [B, H, W, C]: windowed (window_size > 0) or global
    attention, with SAM's decomposed relative positions over `rel_size`
    positions per axis (the window, or the grid for a global block)."""

    def __init__(self, width: int, heads: int, window_size: int, rel_size: int, dtype,
                 device=None):
        super().__init__()
        self.heads, self.window_size = heads, window_size
        self.ln1 = LayerNorm(width, dtype, device)
        for name in ("q", "k", "v", "proj"):
            setattr(self, name, Dense(width, width, dtype, device))
        D = width // heads
        f32 = dict(dtype=torch.float32, device=device)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * rel_size - 1, D, **f32))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * rel_size - 1, D, **f32))
        self.ln2 = LayerNorm(width, dtype, device)
        self.fc1 = Dense(width, 4 * width, dtype, device)
        self.fc2 = Dense(4 * width, width, dtype, device)

    def _rel_pos_bias(self, q: torch.Tensor, size: int) -> torch.Tensor:
        """SAM's add_decomposed_rel_pos: q [B*, T, C], T = size * size ->
        bias [B*, heads, T, T]."""
        nB, _, C = q.shape
        D = C // self.heads
        coords = torch.arange(size, device=q.device)
        rel = coords[:, None] - coords[None, :] + size - 1
        Rh = self.rel_pos_h[rel].to(q.dtype)                  # [s, s, D]
        Rw = self.rel_pos_w[rel].to(q.dtype)
        r_q = q.reshape(nB, size, size, self.heads, D).permute(0, 3, 1, 2, 4)
        bias_h = torch.einsum("bhxyd,xud->bhxyu", r_q, Rh)
        bias_w = torch.einsum("bhxyd,yvd->bhxyv", r_q, Rw)
        bias = bias_h[..., :, None] + bias_w[..., None, :]    # [B*, h, s, s, s, s]
        return bias.reshape(nB, self.heads, size * size, size * size)

    def attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               size: int) -> torch.Tensor:
        """The einsum attention with the relative-position bias on [B*, T, C]
        projections (T = size * size), softmax in fp32."""
        nB, T, C = q.shape
        D = C // self.heads
        split = lambda t: t.reshape(nB, T, self.heads, D).transpose(1, 2)
        logits = torch.einsum("bhtd,bhsd->bhts", split(q), split(k)) / (D ** 0.5)
        logits = logits + self._rel_pos_bias(q / (D ** 0.5), size)
        probs = torch.softmax(logits.float(), dim=-1)
        vh = split(v)
        out = torch.einsum("bhts,bhsd->bhtd", probs.to(vh.dtype), vh)
        return out.transpose(1, 2).reshape(nB, T, C)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        shortcut = x
        x = self.ln1(x)
        ws = self.window_size
        if ws > 0:
            pad_h, pad_w = (ws - H % ws) % ws, (ws - W % ws) % ws
            x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
            Hp, Wp = H + pad_h, W + pad_w
            x = x.reshape(B, Hp // ws, ws, Wp // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
            x = x.reshape(-1, ws * ws, C)
            size = ws
        else:
            if H != W:
                raise ValueError(f"a global block takes a square grid, got {H}x{W}")
            x = x.reshape(B, H * W, C)
            size = H
        x = self.proj(self.attend(self.q(x), self.k(x), self.v(x), size))
        if ws > 0:
            x = x.reshape(B, Hp // ws, Wp // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
            x = x.reshape(B, Hp, Wp, C)[:, :H, :W]
        else:
            x = x.reshape(B, H, W, C)
        x = shortcut + x
        return x + self.fc2(F.gelu(self.fc1(self.ln2(x)), approximate="tanh"))


class SamImageEncoder(nn.Module):
    def __init__(self, cfg: SamConfig, device=None):
        super().__init__()
        self.config = cfg
        kw = dict(dtype=cfg.dtype, device=device)
        W, p, hw = cfg.encoder_width, cfg.patch_size, cfg.embed_hw
        self.patch_embed = nn.Conv2d(3, W, p, stride=p, **kw)
        self.pos_embed = nn.Parameter(torch.zeros(1, hw, hw, W, dtype=torch.float32,
                                                  device=device))
        for i in range(cfg.encoder_layers):
            glob = i in cfg.encoder_global_attn_indexes
            setattr(self, f"block_{i}", SamViTBlock(
                W, cfg.encoder_heads, 0 if glob else cfg.window_size,
                hw if glob else cfg.window_size, cfg.dtype, device))
        D = cfg.prompt_embed_dim
        self.neck_conv1 = nn.Conv2d(W, D, 1, bias=False, **kw)
        self.neck_ln1 = LayerNorm(D, cfg.dtype, device)
        self.neck_conv2 = nn.Conv2d(D, D, 3, padding=1, bias=False, **kw)
        self.neck_ln2 = LayerNorm(D, cfg.dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, 3, H, W] (the sample dicts' layout) -> [B, h, w, D] image
        embeddings."""
        cfg = self.config
        x = self.patch_embed(x.to(cfg.dtype)).permute(0, 2, 3, 1)
        x = x + self.pos_embed.to(cfg.dtype)
        for i in range(cfg.encoder_layers):
            x = getattr(self, f"block_{i}")(x)
        x = self.neck_conv1(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        x = self.neck_ln1(x)
        x = self.neck_conv2(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return self.neck_ln2(x)


class PromptEncoder(nn.Module):
    """Boxes, points and text embeddings -> sparse prompt tokens; the dense
    positional encoding of the image grid (random Fourier features)."""

    def __init__(self, cfg: SamConfig, device=None):
        super().__init__()
        self.config = cfg
        D = cfg.prompt_embed_dim
        f32 = dict(dtype=torch.float32, device=device)
        self.pe_gaussian = nn.Parameter(torch.zeros(2, D // 2, **f32))
        self.point_embeddings = nn.Parameter(torch.zeros(4, D, **f32))  # -, +, 2 box corners
        self.not_a_point = nn.Parameter(torch.zeros(1, D, **f32))
        self.no_mask_embed = nn.Parameter(torch.zeros(1, D, **f32))

    def _pe(self, coords: torch.Tensor) -> torch.Tensor:
        """coords in [0, 1]^2 -> Fourier features [..., D]."""
        proj = (2.0 * coords - 1.0) @ self.pe_gaussian * (2 * math.pi)
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)

    def get_dense_pe(self) -> torch.Tensor:
        hw = self.config.embed_hw
        dev = self.pe_gaussian.device
        ys = (torch.arange(hw, dtype=torch.float32, device=dev) + 0.5) / hw
        xs = (torch.arange(hw, dtype=torch.float32, device=dev) + 0.5) / hw
        return self._pe(torch.stack(torch.meshgrid(xs, ys, indexing="xy"), dim=-1))

    def forward(self, boxes: Optional[torch.Tensor] = None,
                points: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                text_embeds: Optional[torch.Tensor] = None):
        """boxes [B, N, 4] xyxy in pixels; points ([B, N, 2], labels [B, N]);
        text_embeds [B, N, D] -> (sparse [B, T, D], dense [B, h, w, D])."""
        cfg = self.config
        sparse = []
        B = None
        if points is not None:
            pts, labels = points
            B = pts.shape[0]
            pe = self._pe((pts + 0.5) / cfg.img_size)
            pe = pe + torch.where((labels == 1)[..., None], self.point_embeddings[1],
                                  self.point_embeddings[0])
            pe = torch.where((labels == -1)[..., None], self.not_a_point + torch.zeros_like(pe),
                             pe)
            sparse.append(pe)
        if boxes is not None:
            B = boxes.shape[0]
            pe = self._pe((boxes.reshape(B, -1, 2, 2) + 0.5) / cfg.img_size)
            pe = pe + torch.stack([self.point_embeddings[2], self.point_embeddings[3]])
            sparse.append(pe.reshape(B, -1, cfg.prompt_embed_dim))
        if text_embeds is not None:
            B = text_embeds.shape[0]
            sparse.append(text_embeds)
        if not sparse:
            raise ValueError("at least one prompt (boxes, points or text_embeds) is required")
        hw, D = cfg.embed_hw, cfg.prompt_embed_dim
        dense = self.no_mask_embed.reshape(1, 1, 1, D).expand(B, hw, hw, D)
        return torch.cat(sparse, dim=1), dense


class TwoWayBlock(nn.Module):
    """Queries (prompt tokens) and keys (image pixels) attend both ways."""

    def __init__(self, dim: int, heads: int, dtype, device=None, skip_first_pe: bool = False):
        super().__init__()
        self.heads, self.skip_first_pe = heads, skip_first_pe
        for name, inner in (("self", dim), ("cross_qk", dim // 2), ("cross_kq", dim // 2)):
            for part in ("q", "k", "v"):
                setattr(self, f"{name}_{part}", Dense(dim, inner, dtype, device))
            setattr(self, f"{name}_out", Dense(inner, dim, dtype, device))
        for i in range(1, 5):
            setattr(self, f"ln{i}", LayerNorm(dim, dtype, device))
        self.fc1 = Dense(dim, 8 * dim, dtype, device)
        self.fc2 = Dense(8 * dim, dim, dtype, device)

    def _attn(self, name: str, q, k, v):
        part = lambda p, x: getattr(self, f"{name}_{p}")(x)
        return part("out", attention(part("q", q), part("k", k), part("v", v), self.heads))

    def forward(self, queries, keys, query_pe, key_pe):
        q_in = queries if self.skip_first_pe else queries + query_pe
        queries = self.ln1(queries + self._attn("self", q_in, q_in, queries))
        queries = self.ln2(queries + self._attn("cross_qk", queries + query_pe, keys + key_pe,
                                                keys))
        queries = self.ln3(queries + self.fc2(F.relu(self.fc1(queries))))
        keys = self.ln4(keys + self._attn("cross_kq", keys + key_pe, queries + query_pe,
                                          queries))
        return queries, keys


class MaskDecoder(nn.Module):
    def __init__(self, cfg: SamConfig, device=None):
        super().__init__()
        self.config = cfg
        D, dt = cfg.prompt_embed_dim, cfg.dtype
        self.num_tokens = cfg.num_multimask_outputs + 1
        f32 = dict(dtype=torch.float32, device=device)
        self.iou_token = nn.Parameter(torch.zeros(1, D, **f32))
        self.mask_tokens = nn.Parameter(torch.zeros(self.num_tokens, D, **f32))
        for i in range(cfg.decoder_depth):
            setattr(self, f"block_{i}", TwoWayBlock(D, cfg.decoder_heads, dt, device,
                                                    skip_first_pe=(i == 0)))
        for part in ("q", "k", "v"):
            setattr(self, f"final_{part}", Dense(D, D // 2, dt, device))
        self.final_out = Dense(D // 2, D, dt, device)
        self.final_ln = LayerNorm(D, dt, device)
        self.upscale_1 = ConvTranspose2x2(D, D // 4, dt, device)
        self.upscale_ln = LayerNorm(D // 4, dt, device)
        self.upscale_2 = ConvTranspose2x2(D // 4, D // 8, dt, device)
        for i in range(self.num_tokens):
            setattr(self, f"hyper_{i}_fc0", Dense(D, D, dt, device))
            setattr(self, f"hyper_{i}_fc1", Dense(D, D, dt, device))
            setattr(self, f"hyper_{i}_out", Dense(D, D // 8, dt, device))
        self.iou_fc0, self.iou_fc1 = Dense(D, D, dt, device), Dense(D, D, dt, device)
        self.iou_out = Dense(D, self.num_tokens, dt, device)

    def forward(self, image_embeddings, image_pe, sparse_prompts, dense_prompts,
                multimask_output: bool = False):
        """image_embeddings [B, h, w, D]; image_pe [h, w, D]; sparse [B, T, D];
        dense [B, h, w, D] -> (masks [B, M, 4h, 4w], iou_pred [B, M])."""
        cfg = self.config
        D = cfg.prompt_embed_dim
        B, h, w, _ = image_embeddings.shape
        out_tokens = torch.cat([self.iou_token, self.mask_tokens])
        tokens = torch.cat([out_tokens[None].expand(B, -1, -1),
                            sparse_prompts.to(out_tokens.dtype)], dim=1)
        keys = (image_embeddings + dense_prompts).reshape(B, h * w, D)
        pos = image_pe.reshape(1, h * w, D).expand(B, -1, -1)
        queries = tokens
        for i in range(cfg.decoder_depth):
            queries, keys = getattr(self, f"block_{i}")(queries, keys, tokens, pos)
        a = attention(self.final_q(queries + tokens), self.final_k(keys + pos),
                       self.final_v(keys), cfg.decoder_heads)
        queries = self.final_ln(queries + self.final_out(a))
        iou_out, mask_toks = queries[:, 0], queries[:, 1: 1 + self.num_tokens]

        x = keys.reshape(B, h, w, D)                          # upscale 4x
        x = F.gelu(self.upscale_ln(self.upscale_1(x)), approximate="tanh")
        x = F.gelu(self.upscale_2(x), approximate="tanh")     # [B, 4h, 4w, D/8]
        hyper = []
        for i in range(self.num_tokens):
            t = mask_toks[:, i]
            t = F.relu(getattr(self, f"hyper_{i}_fc0")(t))
            t = F.relu(getattr(self, f"hyper_{i}_fc1")(t))
            hyper.append(getattr(self, f"hyper_{i}_out")(t))
        masks = torch.einsum("bmc,bhwc->bmhw", torch.stack(hyper, dim=1), x)
        t = F.relu(self.iou_fc1(F.relu(self.iou_fc0(iou_out))))
        iou_pred = self.iou_out(t)
        if multimask_output:
            return masks[:, 1:], iou_pred[:, 1:]
        return masks[:, :1], iou_pred[:, :1]


class Sam(nn.Module):
    """Full SAM; Spider trains the mask decoder only (it freezes the rest)."""

    def __init__(self, cfg: SamConfig, device=None):
        super().__init__()
        self.config = cfg
        self.image_encoder = SamImageEncoder(cfg, device)
        self.prompt_encoder = PromptEncoder(cfg, device)
        self.mask_decoder = MaskDecoder(cfg, device)

    @property
    def device(self) -> torch.device:
        return self.prompt_encoder.pe_gaussian.device

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        return self.image_encoder(images)

    def decode(self, image_embeddings, boxes=None, points=None, text_embeds=None,
               multimask_output: bool = False):
        sparse, dense = self.prompt_encoder(boxes=boxes, points=points, text_embeds=text_embeds)
        return self.mask_decoder(image_embeddings, self.prompt_encoder.get_dense_pe(), sparse,
                                 dense, multimask_output)

    def predict_box(self, images: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """images [B, 3, H, W]; boxes [B, 1, 4] -> low-res masks [B, 1, 4h, 4w]."""
        with torch.no_grad():
            emb = self.image_encoder(images)
        return self.decode(emb, boxes=boxes)[0]

    def predict_text(self, images: torch.Tensor, text_embeds: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            emb = self.image_encoder(images)
        return self.decode(emb, text_embeds=text_embeds)[0]

    def forward(self, images, boxes=None, text_embeds=None):
        if boxes is not None:
            return self.predict_box(images, boxes)
        return self.predict_text(images, text_embeds)


def postprocess_masks(masks: torch.Tensor, input_size: Tuple[int, int],
                      original_size: Tuple[int, int], img_size: int = 1024) -> torch.Tensor:
    """Upscale low-res masks to the padded input frame, crop, resize to the
    original image (segment_anything's Sam.postprocess_masks), in fp32.
    Both resizes are ``jax.image.resize(..., "bilinear")``: half-pixel
    centres, and a triangle filter widened by the scale when it shrinks
    (torch's ``antialias=True``)."""

    def resize(x, size):
        if tuple(x.shape[-2:]) == tuple(size):
            return x
        return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False,
                             antialias=True)

    up = resize(masks.float(), (img_size, img_size))[:, :, : input_size[0], : input_size[1]]
    return resize(up, original_size)
