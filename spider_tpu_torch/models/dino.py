"""Grounding DINO (counterpart of spider_tpu/models/dino.py): the
open-vocabulary detector behind the BOX decoder. A Swin backbone and a BERT
text encoder feed a deformable-DETR encoder with image-text fusion, then
language-guided query selection and a decoder with per-layer box
refinement.

Attention by kind, as the reference computes it: the decoder's query
self-attention goes through ``ops.attention.attention``, so on the card it is the
flash kernel (900 queries, 8 heads of 32); the text self-attention and the
queries' text cross-attention are the plain ``mha_reference`` with the live
text length; the image-text fusion (``BiAttentionBlock``) is an einsum
softmaxed both ways; the deformable attention is ``ops/msda.py``. The neck
convolutions run in NCHW, everything else channels-last; LayerNorm's eps is
1e-6 (flax's default), GroupNorm's 1e-5 as the reference sets it, with its
statistics in fp32. The
reference points, sine embeddings, box logits and the fusion softmax keep
the reference's fp32. Names follow the JAX tree.

``GroundingDINOInference`` keeps mmdet's ``inference_detector(model, image,
text_prompt)`` contract: a numpy image and a caption in, the top boxes in
the original image's pixels out, by score. It runs eagerly on the model's
device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from spider_tpu_torch.models.bert import BertConfig, BertModel, bert_base, bert_test
from spider_tpu_torch.models.swin import SwinConfig, SwinTransformer, swin_test, swin_tiny
from spider_tpu_torch.ops.attention import attention, mha_reference
from spider_tpu_torch.ops.msda import msda

LN_EPS = 1e-6
# ContrastiveEmbed's scalar bias starts at -log((1 - 0.01) / 0.01).
CLS_BIAS_INIT = -math.log((1 - 0.01) / 0.01)


@dataclasses.dataclass(frozen=True)
class GroundingDINOConfig:
    hidden_dim: int = 256
    num_heads: int = 8
    num_levels: int = 4
    num_points: int = 4
    enc_layers: int = 6
    dec_layers: int = 6
    num_queries: int = 900
    ffn_dim: int = 2048
    max_text_len: int = 256
    backbone: SwinConfig = dataclasses.field(default_factory=swin_tiny)
    bert: BertConfig = dataclasses.field(default_factory=bert_base)
    dtype: torch.dtype = torch.float32


def grounding_dino_tiny() -> GroundingDINOConfig:
    """Swin-T + BERT-base (the deployed config,
    grounding_dino_swin-t_pretrain_obj365_goldg_grit9m_v3det)."""
    return GroundingDINOConfig()


def grounding_dino_test() -> GroundingDINOConfig:
    return GroundingDINOConfig(
        hidden_dim=32, num_heads=4, num_levels=4, num_points=2, enc_layers=1, dec_layers=2,
        num_queries=20, ffn_dim=64, max_text_len=16, backbone=swin_test(), bert=bert_test())


def with_dtype(cfg: GroundingDINOConfig, dtype: torch.dtype) -> GroundingDINOConfig:
    """`cfg` with `dtype` for the detector, its backbone and its text encoder."""
    return dataclasses.replace(cfg, dtype=dtype,
                               backbone=dataclasses.replace(cfg.backbone, dtype=dtype),
                               bert=dataclasses.replace(cfg.bert, dtype=dtype))


def _inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(eps, 1 - eps)
    return torch.log(x / (1 - x))


def _sine_embed(coords: torch.Tensor, num_feats: int,
                temperature: float = 10000.0) -> torch.Tensor:
    """Sine/cosine encoding per coordinate: [..., C] -> [..., C * num_feats]
    (deformable-DETR convention), in fp32."""
    dim_t = torch.arange(num_feats // 2, dtype=torch.float32, device=coords.device)
    dim_t = temperature ** (2 * dim_t / num_feats)
    pos = coords[..., None] * 2 * math.pi / dim_t
    out = torch.cat([torch.sin(pos), torch.cos(pos)], dim=-1)
    return out.reshape(coords.shape[:-1] + (-1,))


def _grid(h: int, w: int, device) -> torch.Tensor:
    """[h * w, 2] pixel centres (x, y) in [0, 1], row-major, fp32."""
    ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
    xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
    return torch.stack(torch.meshgrid(xs, ys, indexing="xy"), dim=-1).reshape(-1, 2)


def _linears(module: nn.Module, names: Sequence[str], d_in: int, d_out: int, kw) -> None:
    for name in names:
        setattr(module, name, nn.Linear(d_in, d_out, **kw))


class MSDeformAttnLayer(nn.Module):
    """One multi-scale deformable attention block (self or cross)."""

    def __init__(self, cfg: GroundingDINOConfig, device=None):
        super().__init__()
        self.config = cfg
        C, H, L, P = cfg.hidden_dim, cfg.num_heads, cfg.num_levels, cfg.num_points
        kw = dict(dtype=cfg.dtype, device=device)
        self.value_proj = nn.Linear(C, C, **kw)
        self.sampling_offsets = nn.Linear(C, H * L * P * 2, **kw)
        self.attention_weights = nn.Linear(C, H * L * P, **kw)
        self.output_proj = nn.Linear(C, C, **kw)

    def forward(self, query, value, reference_points, spatial_shapes):
        """query [B, Q, C]; value [B, S, C]; reference_points [B, Q, 2] or
        [B, Q, 4] (normalised cxcy(wh))."""
        cfg = self.config
        B, Q, C = query.shape
        H, L, P = cfg.num_heads, cfg.num_levels, cfg.num_points
        v = self.value_proj(value).reshape(B, -1, H, C // H)
        offsets = self.sampling_offsets(query).reshape(B, Q, H, L, P, 2)
        weights = torch.softmax(self.attention_weights(query).reshape(B, Q, H, L * P).float(),
                                dim=-1).reshape(B, Q, H, L, P).to(cfg.dtype)
        shapes = torch.tensor(spatial_shapes, dtype=torch.float32, device=query.device)
        wh = shapes.flip(-1)[None, None, None, :, None, :]       # x = w, y = h
        if reference_points.shape[-1] == 2:
            loc = reference_points[:, :, None, None, None, :] + offsets / wh
        else:
            ref_xy = reference_points[:, :, None, None, None, :2]
            ref_wh = reference_points[:, :, None, None, None, 2:]
            loc = ref_xy + offsets / P * ref_wh * 0.5
        return self.output_proj(msda(v, spatial_shapes, loc, weights))


class BiAttentionBlock(nn.Module):
    """GLIP-style bidirectional image<->text fusion: one attention-logit
    tensor per head, softmaxed both ways in fp32, values projected on both
    sides (BiMultiHeadAttention semantics)."""

    def __init__(self, cfg: GroundingDINOConfig, device=None):
        super().__init__()
        C, kw = cfg.hidden_dim, dict(dtype=cfg.dtype, device=device)
        self.heads = cfg.num_heads
        self.ln_img = nn.LayerNorm(C, eps=LN_EPS, **kw)
        self.ln_txt = nn.LayerNorm(C, eps=LN_EPS, **kw)
        _linears(self, ("img_q", "txt_k", "img_v", "txt_v", "img_out", "txt_out"), C, C, kw)
        f32 = dict(dtype=torch.float32, device=device)
        self.gamma_img = nn.Parameter(torch.full((C,), 1e-4, **f32))
        self.gamma_txt = nn.Parameter(torch.full((C,), 1e-4, **f32))

    def forward(self, img, txt):
        B, S, C = img.shape
        T = txt.shape[1]
        H = self.heads
        D = C // H
        i, t = self.ln_img(img), self.ln_txt(txt)
        qi = self.img_q(i).reshape(B, S, H, D)
        kt = self.txt_k(t).reshape(B, T, H, D)
        vi = self.img_v(i).reshape(B, S, H, D)
        vt = self.txt_v(t).reshape(B, T, H, D)
        logits = (torch.einsum("bshd,bthd->bhst", qi, kt) / math.sqrt(D)).float()
        logits = logits.clamp(-50000.0, 50000.0)       # GLIP clamps the fused logits
        a_i2t = torch.softmax(logits, dim=-1)
        a_t2i = torch.softmax(logits.transpose(2, 3), dim=-1)
        img_attn = torch.einsum("bhst,bthd->bshd", a_i2t.to(vt.dtype), vt)
        txt_attn = torch.einsum("bhts,bshd->bthd", a_t2i.to(vi.dtype), vi)
        img = img + self.gamma_img.to(img.dtype) * self.img_out(img_attn.reshape(B, S, C))
        txt = txt + self.gamma_txt.to(txt.dtype) * self.txt_out(txt_attn.reshape(B, T, C))
        return img, txt


class EncoderLayer(nn.Module):
    """Feature enhancer layer: fusion, then the text's self-attention and
    FFN, then the image's deformable self-attention and FFN."""

    def __init__(self, cfg: GroundingDINOConfig, device=None):
        super().__init__()
        C, F_, kw = cfg.hidden_dim, cfg.ffn_dim, dict(dtype=cfg.dtype, device=device)
        self.heads = cfg.num_heads
        self.fusion = BiAttentionBlock(cfg, device)
        _linears(self, ("txt_q", "txt_k", "txt_v", "txt_attn_out"), C, C, kw)
        self.txt_fc1, self.txt_fc2 = nn.Linear(C, F_, **kw), nn.Linear(F_, C, **kw)
        self.msda = MSDeformAttnLayer(cfg, device)
        self.img_fc1, self.img_fc2 = nn.Linear(C, F_, **kw), nn.Linear(F_, C, **kw)
        for name in ("txt_ln1", "txt_ln2", "img_ln1", "img_ln2"):
            setattr(self, name, nn.LayerNorm(C, eps=LN_EPS, **kw))

    def forward(self, img, txt, ref_points, spatial_shapes, txt_len):
        img, txt = self.fusion(img, txt)
        B, T, C = txt.shape
        split = lambda t: t.reshape(B, T, self.heads, C // self.heads)
        attn = mha_reference(split(self.txt_q(txt)), split(self.txt_k(txt)),
                             split(self.txt_v(txt)), causal=False, kv_len=txt_len)
        txt = self.txt_ln1(txt + self.txt_attn_out(attn.reshape(B, T, C)))
        txt = self.txt_ln2(txt + self.txt_fc2(F.relu(self.txt_fc1(txt))))
        img = self.img_ln1(img + self.msda(img, img, ref_points, spatial_shapes))
        img = self.img_ln2(img + self.img_fc2(F.relu(self.img_fc1(img))))
        return img, txt


class DecoderLayer(nn.Module):
    def __init__(self, cfg: GroundingDINOConfig, device=None):
        super().__init__()
        C, F_, kw = cfg.hidden_dim, cfg.ffn_dim, dict(dtype=cfg.dtype, device=device)
        self.heads = cfg.num_heads
        _linears(self, ("self_q", "self_k", "self_v", "self_out",
                        "txt_q", "txt_k", "txt_v", "txt_out"), C, C, kw)
        self.msda = MSDeformAttnLayer(cfg, device)
        self.fc1, self.fc2 = nn.Linear(C, F_, **kw), nn.Linear(F_, C, **kw)
        for name in ("ln1", "ln2", "ln3", "ln4"):
            setattr(self, name, nn.LayerNorm(C, eps=LN_EPS, **kw))

    def forward(self, queries, query_pos, memory, txt, ref_boxes, spatial_shapes, txt_len):
        B, Q, C = queries.shape
        H = self.heads
        qk = queries + query_pos
        a = attention(self.self_q(qk), self.self_k(qk), self.self_v(queries), H)
        queries = self.ln1(queries + self.self_out(a))
        T = txt.shape[1]
        a = mha_reference(self.txt_q(queries + query_pos).reshape(B, Q, H, C // H),
                          self.txt_k(txt).reshape(B, T, H, C // H),
                          self.txt_v(txt).reshape(B, T, H, C // H),
                          causal=False, kv_len=txt_len)
        queries = self.ln2(queries + self.txt_out(a.reshape(B, Q, C)))
        a = self.msda(queries + query_pos, memory, ref_boxes, spatial_shapes)
        queries = self.ln3(queries + a)
        return self.ln4(queries + self.fc2(F.relu(self.fc1(queries))))


class BoxHead(nn.Module):
    def __init__(self, C: int, dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.fc0, self.fc1, self.out = nn.Linear(C, C, **kw), nn.Linear(C, C, **kw), \
            nn.Linear(C, 4, **kw)

    def forward(self, x):
        return self.out(F.relu(self.fc1(F.relu(self.fc0(x)))))


class GroundingDINO(nn.Module):
    def __init__(self, cfg: GroundingDINOConfig, device=None):
        super().__init__()
        self.config = cfg
        C, kw = cfg.hidden_dim, dict(dtype=cfg.dtype, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        self.backbone = SwinTransformer(cfg.backbone, device)
        widths = [cfg.backbone.embed_dim * 2 ** s for s in cfg.backbone.out_indices]
        # ChannelMapper: 1x1 conv + GroupNorm(32) per backbone level, and an
        # extra stride-2 3x3 level on the last feature map.
        for i, w in enumerate(widths):
            setattr(self, f"neck_in{i}", nn.Conv2d(w, C, 1, **kw))
            setattr(self, f"neck_gn{i}", nn.GroupNorm(32, C, eps=1e-5, **kw))
        self.neck_extra = nn.Conv2d(widths[-1], C, 3, stride=2, padding=1, **kw)
        self.neck_extra_gn = nn.GroupNorm(32, C, eps=1e-5, **kw)
        self.level_embed = nn.Parameter(torch.zeros(cfg.num_levels, C, **f32))
        self.bert = BertModel(cfg.bert, device)
        self.text_proj = nn.Linear(cfg.bert.hidden_size, C, **kw)
        for i in range(cfg.enc_layers):
            setattr(self, f"enc_{i}", EncoderLayer(cfg, device))
        self.enc_out_proj = nn.Linear(C, C, **kw)
        self.enc_out_ln = nn.LayerNorm(C, eps=LN_EPS, **kw)
        self.enc_cls_bias = nn.Parameter(torch.full((1,), CLS_BIAS_INIT, **f32))
        self.enc_box_head = BoxHead(C, cfg.dtype, device)
        self.query_embedding = nn.Parameter(torch.zeros(cfg.num_queries, C, **f32))
        self.ref_point_fc1 = nn.Linear(2 * C, C, **kw)
        self.ref_point_fc2 = nn.Linear(C, C, **kw)
        for i in range(cfg.dec_layers):
            setattr(self, f"dec_{i}", DecoderLayer(cfg, device))
            setattr(self, f"dec_box_head_{i}", BoxHead(C, cfg.dtype, device))
        self.decoder_norm = nn.LayerNorm(C, eps=LN_EPS, **kw)
        self.cls_bias = nn.Parameter(torch.full((1,), CLS_BIAS_INIT, **f32))

    @staticmethod
    def _neck(conv: nn.Conv2d, norm: nn.GroupNorm, f: torch.Tensor) -> torch.Tensor:
        """conv then GroupNorm, NHWC in and out. The statistics are taken in
        fp32 over each group's pixels and channels, as flax does, also where
        a group holds one value (torch's group_norm refuses that)."""
        x = conv(f.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        B, H, W, C = x.shape
        G = norm.num_groups
        xf = x.float().reshape(B, H * W, G, C // G)
        mean = xf.mean(dim=(1, 3), keepdim=True)
        var = (xf - mean).square().mean(dim=(1, 3), keepdim=True)
        y = ((xf - mean) * torch.rsqrt(var + norm.eps)).reshape(B, H, W, C)
        return (y * norm.weight.float() + norm.bias.float()).to(x.dtype)

    def _ref_point_head(self, boxes: torch.Tensor) -> torch.Tensor:
        """The shared ref_point_head (deformable-DETR): the sine embedding of
        the 4 box coordinates through a 2-layer MLP."""
        e = _sine_embed(boxes.detach(), self.config.hidden_dim // 2)
        return self.ref_point_fc2(F.relu(self.ref_point_fc1(e.to(self.config.dtype))))

    def forward(self, images: torch.Tensor, text_ids: torch.Tensor,
                text_mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """images [B, 3, H, W]; text_ids [B, T] -> dict(boxes: cxcywh
        normalised [B, K, 4] fp32, scores [B, K], logits [B, K, T])."""
        cfg = self.config
        B, C, dt = images.shape[0], cfg.hidden_dim, cfg.dtype
        feats = self.backbone(images)
        levels = [self._neck(getattr(self, f"neck_in{i}"), getattr(self, f"neck_gn{i}"), f)
                  for i, f in enumerate(feats)]
        levels.append(self._neck(self.neck_extra, self.neck_extra_gn, feats[-1]))
        levels = levels[: cfg.num_levels]
        spatial_shapes = tuple((f.shape[1], f.shape[2]) for f in levels)
        dev = images.device
        img = torch.cat([f.reshape(B, -1, C) + _sine_embed(_grid(*hw, dev), C // 2)[None].to(dt)
                         + self.level_embed[i].to(dt)
                         for i, (f, hw) in enumerate(zip(levels, spatial_shapes))], dim=1)

        txt_raw, _ = self.bert(text_ids, text_mask)
        txt = self.text_proj(txt_raw)
        txt_len = text_mask.sum(-1).to(torch.int32) if text_mask is not None else None
        t_mask = (torch.arange(txt.shape[1], device=dev)[None, None, :] < txt_len[:, None, None]
                  if txt_len is not None else None)

        enc_ref = torch.cat([_grid(*hw, dev) for hw in spatial_shapes])[None].expand(B, -1, -1)
        for i in range(cfg.enc_layers):
            img, txt = getattr(self, f"enc_{i}")(img, txt, enc_ref, spatial_shapes, txt_len)

        # language-guided query selection (ContrastiveEmbed: sim / sqrt(C) + bias)
        enc_out = self.enc_out_ln(self.enc_out_proj(img))
        sim = torch.einsum("bsc,btc->bst", enc_out, txt) / math.sqrt(C) + self.enc_cls_bias.to(dt)
        if t_mask is not None:
            sim = torch.where(t_mask, sim, torch.tensor(-1e9, dtype=sim.dtype, device=dev))
        token_scores = sim.amax(dim=-1)                      # [B, S]
        K = min(cfg.num_queries, token_scores.shape[1])
        # jax.lax.top_k's order: descending, ties by the lower index
        topk = torch.sort(token_scores, dim=1, descending=True, stable=True).indices[:, :K]
        sel = torch.gather(enc_out, 1, topk[..., None].expand(-1, -1, C))
        anchor_xy = torch.gather(enc_ref, 1, topk[..., None].expand(-1, -1, 2))
        delta = self.enc_box_head(sel)
        init_boxes = torch.cat([_inverse_sigmoid(anchor_xy) + delta[..., :2],
                                delta[..., 2:].float()], dim=-1)
        ref_boxes = torch.sigmoid(init_boxes)                # [B, K, 4] cxcywh, fp32
        queries = self.query_embedding[None, :K].to(dt).expand(B, K, C)

        for i in range(cfg.dec_layers):
            query_pos = self._ref_point_head(ref_boxes)      # from the current boxes
            queries = getattr(self, f"dec_{i}")(queries, query_pos, img, txt, ref_boxes,
                                                spatial_shapes, txt_len)
            delta = getattr(self, f"dec_box_head_{i}")(queries)
            ref_boxes = torch.sigmoid(_inverse_sigmoid(ref_boxes) + delta).detach()

        queries = self.decoder_norm(queries)
        logits = torch.einsum("bkc,btc->bkt", queries, txt) / math.sqrt(C) + self.cls_bias.to(dt)
        if t_mask is not None:
            logits = torch.where(t_mask, logits,
                                 torch.tensor(-1e9, dtype=logits.dtype, device=dev))
        scores = torch.sigmoid(logits.amax(dim=-1))
        return dict(boxes=ref_boxes, scores=scores, logits=logits)


class GroundingDINOInference:
    """``inference_detector(model, image, text_prompt)``
    (mmdet/apis/inference.py:122-178): a numpy HWC image and a caption ->
    {bboxes: xyxy in the original pixels, label_names, scores}, the top
    `max_dets` by score."""

    def __init__(self, model: GroundingDINO, tokenizer, image_size: int = 512,
                 max_dets: int = 300):
        self.model = model
        self.tokenizer = tokenizer
        self.image_size = image_size
        self.max_dets = max_dets

    @property
    def device(self) -> torch.device:
        return self.model.level_embed.device

    def inputs(self, image: np.ndarray, caption: str
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(image [1, 3, s, s] fp32, ids [1, T], mask [1, T]) on the model's
        device: resized and zero-padded to image_size, ImageNet-normalised,
        the caption's ids cut or padded to max_text_len."""
        from spider_tpu_torch.processors.vision import detr_preprocess, resize_pad

        chw = detr_preprocess(resize_pad(image, self.image_size).transpose(2, 0, 1))
        T = self.model.config.max_text_len
        ids = list(self.tokenizer(caption, add_special_tokens=True).input_ids)[:T]
        mask = [1] * len(ids) + [0] * (T - len(ids))
        ids = ids + [0] * (T - len(ids))
        dev = self.device
        return (torch.from_numpy(np.ascontiguousarray(chw))[None].to(dev),
                torch.tensor([ids], dtype=torch.int32, device=dev),
                torch.tensor([mask], dtype=torch.int32, device=dev))

    @torch.inference_mode()
    def raw(self, image: np.ndarray, caption: str) -> Dict[str, torch.Tensor]:
        """The model's outputs (boxes, scores, logits) before sorting."""
        return self.model(*self.inputs(image, caption))

    def __call__(self, image: np.ndarray, caption: str) -> Dict[str, list]:
        oh, ow = image.shape[:2]
        out = self.raw(image, caption)
        boxes = out["boxes"][0].float().cpu().numpy()        # cxcywh normalised
        scores = out["scores"][0].float().cpu().numpy()
        order = np.argsort(-scores)[: self.max_dets]
        boxes, scores = boxes[order], scores[order]
        # cxcywh in the padded frame -> xyxy in the original pixels
        scale = max(oh, ow)
        cx, cy, w, h = boxes.T
        xyxy = np.stack([(cx - w / 2) * scale, (cy - h / 2) * scale,
                         (cx + w / 2) * scale, (cy + h / 2) * scale], axis=1)
        xyxy[:, 0::2] = np.clip(xyxy[:, 0::2], 0, ow)
        xyxy[:, 1::2] = np.clip(xyxy[:, 1::2], 0, oh)
        return dict(bboxes=[b.tolist() for b in xyxy], label_names=[caption] * len(xyxy),
                    scores=scores.tolist())
