"""Random-init builders of the port's models on an explicit device, from a
seeded ``torch.Generator`` (counterpart of the random-init branches of
spider_tpu/models/factory.py): the full-size serving models
(``from_pretrained``) and the trainable Spider at test scale
(``build_tiny_spider``) and at full width (``build_full_spider``). Weight
values do not change the work a forward pass does; real weights load through
spider_tpu/models/convert.py and ``convert.load_jax_params``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from spider_tpu_torch.models import llama as L
from spider_tpu_torch.models.tokenizer import TinyTokenizer, extend_tokenizer

# Standard deviation of an int8 weight drawn uniformly from [-127, 127], and
# of an int4 weight, a nibble of a uniformly drawn byte, uniform in [-8, 7].
_INT8_STD = (((2 * 127 + 1) ** 2 - 1) / 12) ** 0.5
_INT4_STD = ((16 ** 2 - 1) / 12) ** 0.5
# Multiplicative scales start at 1 (HiFi-GAN divides by its raw ``scale``).
_ONES = ("input_layernorm", "post_attention_layernorm", "norm", "kernel_scale", "scale")


def random_init_(module: nn.Module, generator: torch.Generator,
                 scale: float = 0.02) -> nn.Module:
    """Fill every parameter and persistent buffer in place: float weights
    ~ N(0, scale); norm scales 1 and norm biases 0; int8 ``kernel_q``
    uniform in [-127, 127], or for an int4 module every packed byte uniform
    in [-128, 127] (each nibble uniform in [-8, 7]), with ``kernel_scale`` =
    scale / the weight's std, so a quantized projection has the same
    effective spread as a float one; ``lora_b`` zeros, so a LoRA branch
    starts as the identity."""
    with torch.no_grad():
        for mod in module.modules():
            norm = isinstance(mod, (nn.LayerNorm, nn.GroupNorm))
            own = dict(mod.named_parameters(recurse=False))
            own.update((n, b) for n, b in mod.named_buffers(recurse=False)
                       if n not in mod._non_persistent_buffers_set)
            int4 = getattr(mod, "quantization", None) == "int4"
            for name, t in own.items():
                if t is None:
                    continue
                if norm:
                    t.fill_(1.0 if name == "weight" else 0.0)
                elif name == "kernel_q":
                    t.random_(-128 if int4 else -127, 128, generator=generator)
                elif name == "kernel_scale":
                    t.fill_(scale / (_INT4_STD if int4 else _INT8_STD))
                elif name in _ONES:
                    t.fill_(1.0)
                elif name == "lora_b":
                    t.zero_()
                elif t.is_floating_point():
                    t.normal_(0.0, scale, generator=generator)
    return module


def build_llama(cfg: L.LlamaConfig, device, seed: int = 0) -> L.LlamaForCausalLM:
    gen = torch.Generator(device=device).manual_seed(seed)
    return random_init_(L.LlamaForCausalLM(cfg, device).eval(), gen)


def llama3_8b_quantized(quantization: str = "int8") -> L.LlamaConfig:
    """The serving configuration of the chat backbone: llama3_8b with int8
    (or, given 'int4', int4) weight-only projections and bf16 embeddings and
    norms."""
    return dataclasses.replace(L.llama3_8b(), quantization=quantization,
                               param_dtype=torch.bfloat16)


def from_pretrained(kind: str, *, device, dtype: torch.dtype = torch.bfloat16,
                    seed: int = 0, quantization: str = "int8"):
    """Full-size random-init model on `device`.

    kinds: 'sd15' -> StableDiffusionPipeline at 512px (text encoder, UNet
    and VAE in `dtype`); 'zeroscope' -> TextToVideoSDPipeline at 576x320
    (CLIP ViT-H, the 1.4B UNet3D and the SD VAE in `dtype`); 'audioldm' ->
    AudioLDMPipeline (CLAP text, the AudioLDM-l UNet and mel VAE in `dtype`;
    the HiFi-GAN vocoder in fp32, as the reference computes it); 'llama' ->
    (LlamaForCausalLM 8B with `quantization` 'int8' or 'int4' projections,
    TinyTokenizer).
    'imagebind' -> ImageBindEncoder (imagebind_huge) in `dtype`.
    There is no checkpoint path yet: convert a checkpoint with
    spider_tpu/models/convert.py, then fill the returned module with
    ``spider_tpu_torch.models.convert.load_jax_params``.
    """
    if kind == "llama":
        if quantization not in ("int8", "int4"):
            raise ValueError(f"llama quantization must be 'int8' or 'int4', got "
                             f"{quantization!r}")
        return build_llama(llama3_8b_quantized(quantization), device, seed), TinyTokenizer()
    if kind == "sd15":
        from spider_tpu_torch.models.clip_text import CLIPTextModel, clip_vit_l14
        from spider_tpu_torch.models.pipelines.sd import StableDiffusionPipeline
        from spider_tpu_torch.models.unet2d import UNet2DConditionModel, unet_sd15
        from spider_tpu_torch.models.vae import AutoencoderKL, vae_sd

        gen = torch.Generator(device=device).manual_seed(seed)
        text = CLIPTextModel(dataclasses.replace(clip_vit_l14(), dtype=dtype), device)
        unet = UNet2DConditionModel(dataclasses.replace(unet_sd15(), dtype=dtype), device)
        vae = AutoencoderKL(dataclasses.replace(vae_sd(), dtype=dtype), device)
        for m in (text, unet, vae):
            random_init_(m.eval(), gen)
        return StableDiffusionPipeline(TinyTokenizer(), text, unet, vae, height=512,
                                       width=512)
    if kind == "zeroscope":
        from spider_tpu_torch.models.clip_text import CLIPTextModel, clip_vit_h14
        from spider_tpu_torch.models.pipelines.vd import TextToVideoSDPipeline
        from spider_tpu_torch.models.unet3d import UNet3DConditionModel, unet3d_zeroscope
        from spider_tpu_torch.models.vae import AutoencoderKL, vae_sd

        gen = torch.Generator(device=device).manual_seed(seed)
        text = CLIPTextModel(dataclasses.replace(clip_vit_h14(), dtype=dtype), device)
        unet = UNet3DConditionModel(dataclasses.replace(unet3d_zeroscope(), dtype=dtype),
                                    device)
        vae = AutoencoderKL(dataclasses.replace(vae_sd(), dtype=dtype), device)
        for m in (text, unet, vae):
            random_init_(m.eval(), gen)
        return TextToVideoSDPipeline(TinyTokenizer(), text, unet, vae)
    if kind == "audioldm":
        from spider_tpu_torch.models.clip_text import ClapTextConfig, ClapTextModel
        from spider_tpu_torch.models.pipelines.ad import AudioLDMPipeline
        from spider_tpu_torch.models.unet2d import UNet2DConditionModel, unet_audioldm
        from spider_tpu_torch.models.vae import AutoencoderKL, vae_audioldm
        from spider_tpu_torch.models.vocoder import HifiGan, hifigan_audioldm

        gen = torch.Generator(device=device).manual_seed(seed)
        tcfg = dataclasses.replace(ClapTextConfig(), dtype=dtype)
        # The cross-attention context is the CLAP vector itself, so its
        # width is the CLAP projection width (pipelines/ad.py).
        ucfg = dataclasses.replace(unet_audioldm(), dtype=dtype,
                                   cross_attention_dim=tcfg.projection_dim,
                                   addition_embed_type="class_embed",
                                   projection_class_embeddings_input_dim=tcfg.projection_dim)
        text = ClapTextModel(tcfg, device)
        unet = UNet2DConditionModel(ucfg, device)
        vae = AutoencoderKL(dataclasses.replace(vae_audioldm(), dtype=dtype), device)
        vocoder = HifiGan(hifigan_audioldm(), device)
        for m in (text, unet, vae, vocoder):
            random_init_(m.eval(), gen)
        return AudioLDMPipeline(TinyTokenizer(), text, unet, vae, vocoder, mel_bins=64)
    if kind == "imagebind":
        from spider_tpu_torch.models.imagebind import ImageBindEncoder, imagebind_huge

        gen = torch.Generator(device=device).manual_seed(seed)
        cfg = dataclasses.replace(imagebind_huge(), dtype=dtype)
        return random_init_(ImageBindEncoder(cfg, device).eval(), gen)
    raise ValueError(f"unknown kind {kind!r} (expected 'sd15', 'zeroscope', 'audioldm', "
                     f"'imagebind' or 'llama')")


# ---------------------------------------------------------------------------
# the trainable Spider
# ---------------------------------------------------------------------------

# Full-size operating point: 77 conditioning tokens into SD-1.5 (768) and
# ZeroScope (1024), 1 into AudioLDM's CLAP space (512) and the SAM prompt
# space (256).
FULL_ALIGN_SPECS = {
    "IMAGE": dict(alignment_input_tokens=1, alignment_output_tokens=77,
                  alignment_output_dim=768),
    "VIDEO": dict(alignment_input_tokens=1, alignment_output_tokens=77,
                  alignment_output_dim=1024),
    "AUDIO": dict(alignment_input_tokens=1, alignment_output_tokens=1,
                  alignment_output_dim=512),
    "MASK": dict(alignment_input_tokens=1, alignment_output_tokens=1,
                 alignment_output_dim=256),
}

_SPIDER_KWARGS = ("max_context_len", "only_llm_gen_loss", "use_embed_align_loss",
                  "only_embed_align_loss", "word_align_loss", "alignment_layer")


def _build_aligners(hidden_size: int, specs: Dict[str, Dict], use_moe: bool, hidden_dim: int,
                    num_expert_layers: int, device, gen):
    """(aligners dict, moe_aligner): one of the two is empty."""
    from spider_tpu_torch.models.aligners import TextFcLayer, TextFcLayerMoE

    if use_moe:
        moe = TextFcLayerMoE(hidden_size, specs, mode="moe_transformer",
                             hidden_dim=hidden_dim, num_expert_layers=num_expert_layers,
                             device=device)
        return {}, random_init_(moe, gen)
    aligners = {
        m: random_init_(TextFcLayer(hidden_size, spec["alignment_output_dim"],
                                    num_input_tokens=spec["alignment_input_tokens"],
                                    num_output_tokens=spec["alignment_output_tokens"],
                                    mode="transformer", hidden_dim=hidden_dim,
                                    device=device), gen)
        for m, spec in specs.items()}
    return aligners, None


def _llama_proj(embed_dim: int, hidden_size: int, device, gen) -> nn.Linear:
    proj = nn.Linear(embed_dim, hidden_size, device=device)
    with torch.no_grad():
        proj.weight.normal_(0.0, 0.02, generator=gen)
        proj.bias.zero_()
    return proj


def build_tiny_spider(*, device, seed: int = 0, use_moe_aligner: bool = False,
                      with_pipes: bool = True, with_sam: bool = False,
                      modality_tokens: Optional[Dict[str, int]] = None, lora_r: int = 4,
                      max_context_len: int = 128, **spider_kwargs):
    """Every component at test scale, random weights. Extra kwargs
    (only_llm_gen_loss, use_embed_align_loss, word_align_loss,
    alignment_layer, ...) pass through to Spider."""
    from spider_tpu_torch.models.imagebind import ImageBindEncoder, imagebind_tiny
    from spider_tpu_torch.models.pipelines.ad import build_tiny_ad
    from spider_tpu_torch.models.pipelines.sd import build_tiny_sd
    from spider_tpu_torch.models.pipelines.vd import build_tiny_vd
    from spider_tpu_torch.models.spider import Spider

    if with_sam:
        raise NotImplementedError("the SAM mask decoder is not ported: with_sam must be False")
    gen = torch.Generator(device=device).manual_seed(seed)
    tokenizer = TinyTokenizer()
    modality_tokens = modality_tokens or {"IMAGE": 4, "VIDEO": 8, "AUDIO": 4,
                                          "MASK": 1, "BOX": 1}
    extend_tokenizer(tokenizer, modality_tokens, bbox_bins=16)

    cfg = L.llama_tiny(vocab_size=len(tokenizer) + 8, lora_r=lora_r)
    llm = random_init_(L.LlamaForCausalLM(cfg, device), gen)
    ib_cfg = imagebind_tiny()
    encoder = random_init_(ImageBindEncoder(ib_cfg, device), gen)
    pipes = {}
    if with_pipes:
        pipes = {"IMAGE": build_tiny_sd(tokenizer=tokenizer, device=device, seed=seed),
                 "VIDEO": build_tiny_vd(tokenizer=tokenizer, device=device, seed=seed),
                 "AUDIO": build_tiny_ad(tokenizer=tokenizer, device=device, seed=seed)}
    # alignment dims follow the pipes' conditioning spaces
    align_specs = {
        "IMAGE": dict(alignment_input_tokens=modality_tokens["IMAGE"],
                      alignment_output_tokens=77, alignment_output_dim=32),
        "VIDEO": dict(alignment_input_tokens=modality_tokens["VIDEO"],
                      alignment_output_tokens=77, alignment_output_dim=32),
        "AUDIO": dict(alignment_input_tokens=modality_tokens["AUDIO"],
                      alignment_output_tokens=1, alignment_output_dim=16),
        "MASK": dict(alignment_input_tokens=1, alignment_output_tokens=1,
                     alignment_output_dim=8),
    }
    aligners, moe = _build_aligners(cfg.hidden_size, align_specs, use_moe_aligner, 32, 1,
                                    device, gen)
    return Spider(llm=llm, tokenizer=tokenizer, encoder=encoder,
                  llama_proj=_llama_proj(ib_cfg.embed_dim, cfg.hidden_size, device, gen),
                  aligners=aligners, moe_aligner=moe, diffusion_pipes=pipes,
                  modality_tokens=modality_tokens, max_context_len=max_context_len,
                  **spider_kwargs)


def build_full_spider(*, device, seed: int = 0, dtype: torch.dtype = torch.bfloat16,
                      lora_r: int = 32, with_encoder: bool = True, with_sam: bool = False,
                      with_pipes: bool = False, use_moe_aligner: bool = True,
                      max_context_len: int = 500, remat: bool = True,
                      diffusion_pipes: Optional[Dict] = None, **spider_kwargs):
    """Full-size trainable Spider at the reference operating point, random
    weights: frozen ImageBind-huge encoder -> input projection -> LoRA-r32
    Llama-3-8B architecture with the extended signal-token vocabulary ->
    moe_transformer aligners (hidden 512, 3 experts x 4+4 layers; dims per
    FULL_ALIGN_SPECS).

    One-card operating point: the base Llama weights are stored in `dtype`
    and frozen (no gradient, no optimizer state); what trains is fp32: the
    LoRA pairs, ``embed_tokens`` and ``lm_head`` (whose first 128256 rows the
    optimizer freezes: ``num_frozen_embed_rows``), the input projection, the
    aligner and ``logit_scale``. ``remat`` recomputes each of the 32 blocks
    in the backward pass. The vocabulary is 128256 + the tokenizer's, rounded
    up to a multiple of 128.

    with_pipes builds resident SD-1.5 / ZeroScope / AudioLDM pipelines for the
    alignment targets; `diffusion_pipes` hands over pipelines already built.
    """
    from spider_tpu_torch.models.spider import Spider

    if with_sam:
        raise NotImplementedError("the SAM mask decoder is not ported: with_sam must be False")
    gen = torch.Generator(device=device).manual_seed(seed)
    tokenizer = TinyTokenizer()
    modality_tokens = {"IMAGE": 1, "VIDEO": 1, "AUDIO": 1, "MASK": 1, "BOX": 1}
    extend_tokenizer(tokenizer, modality_tokens, bbox_bins=0)
    new_vocab = -(-(128256 + len(tokenizer)) // 128) * 128
    cfg = dataclasses.replace(L.llama3_8b(), vocab_size=new_vocab,
                              lora=L.LoraConfig(r=lora_r), dtype=dtype, param_dtype=dtype,
                              remat=remat)
    llm = random_init_(L.LlamaForCausalLM(cfg, device), gen)
    llm.requires_grad_(False)
    for name, p in llm.named_parameters():
        if name.endswith(("lora_a", "lora_b")):
            p.requires_grad_(True)
    for mod in (llm.embed_tokens, llm.lm_head):       # new rows train, in fp32
        mod.weight = nn.Parameter(mod.weight.detach().float())

    encoder = None
    if with_encoder:
        encoder = from_pretrained("imagebind", device=device, dtype=dtype, seed=seed)
    aligners, moe = _build_aligners(cfg.hidden_size, FULL_ALIGN_SPECS, use_moe_aligner, 512,
                                    4, device, gen)
    pipes = dict(diffusion_pipes or {})
    if with_pipes:
        for m, kind in (("IMAGE", "sd15"), ("VIDEO", "zeroscope"), ("AUDIO", "audioldm")):
            pipes.setdefault(m, from_pretrained(kind, device=device, dtype=dtype, seed=seed))
    return Spider(llm=llm, tokenizer=tokenizer, encoder=encoder,
                  llama_proj=_llama_proj(1024, cfg.hidden_size, device, gen),
                  aligners=aligners, moe_aligner=moe, diffusion_pipes=pipes,
                  modality_tokens=modality_tokens, max_context_len=max_context_len,
                  **spider_kwargs)


def build_spider_from_config(model_config: Dict, *, device):
    """Config blob -> Spider on `device`. preset='tiny' builds the test-scale
    model, 'full' the full-width one (random weights; checkpoint paths are
    not ported yet)."""
    cfg = dict(model_config)
    preset = cfg.pop("preset", "tiny")
    if preset == "tiny":
        keys = ("use_moe_aligner", "with_pipes", "modality_tokens", "lora_r") + _SPIDER_KWARGS
        return build_tiny_spider(device=device, **{k: cfg[k] for k in keys if k in cfg})
    if preset == "full":
        if cfg.get("paths"):
            raise NotImplementedError("loading checkpoints by path is not ported: convert "
                                      "them with spider_tpu/models/convert.py and fill the "
                                      "model with convert.load_jax_spider")
        keys = ("lora_r", "with_encoder", "with_sam", "with_pipes",
                "use_moe_aligner") + _SPIDER_KWARGS
        return build_full_spider(device=device, **{k: cfg[k] for k in keys if k in cfg})
    raise ValueError(f"unknown spider preset {preset!r} (expected 'tiny' or 'full')")
