"""Builders of the port's models on an explicit device (counterpart of
spider_tpu/models/factory.py): the full-size serving models
(``from_pretrained``) and the trainable Spider at test scale
(``build_tiny_spider``) and at full width (``build_full_spider``). Without a
checkpoint path they are random from a seeded ``torch.Generator`` (weight
values do not change the work a forward pass does); with one they stream
an HF/diffusers checkpoint through models/convert.py onto the device.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, Optional

import torch
from torch import nn

from spider_tpu_torch.models import convert as C
from spider_tpu_torch.models import llama as L
from spider_tpu_torch.models.tokenizer import TinyTokenizer, extend_tokenizer, load_tokenizer

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


# Files of which an HF tokenizer directory holds at least one.
_TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json", "tokenizer.model", "vocab.json",
                    "vocab.txt", "spiece.model", "merges.txt")


def _hf_tokenizer(path: Optional[str], subfolder: str = "tokenizer"):
    """The checkpoint's HF tokenizer (``<path>/<subfolder>`` if that is a
    directory, else ``path``), or TinyTokenizer when there is no path or it
    cannot be loaded, as spider_tpu/models/factory.py:201-213 falls back.
    Only a local directory holding tokenizer files is handed to
    ``transformers`` (never a name it could look up on a hub, nor a
    directory without a vocabulary, from which some of its versions build
    an empty tokenizer); without the package it is always TinyTokenizer."""
    if path is not None:
        cand = os.path.join(path, subfolder)
        target = cand if os.path.isdir(cand) else path
        if not (os.path.isdir(target) and
                any(os.path.exists(os.path.join(target, f)) for f in _TOKENIZER_FILES)):
            logging.warning("no tokenizer files in %s; using TinyTokenizer", target)
            return TinyTokenizer()
        try:
            return load_tokenizer(target)
        except Exception as e:          # the reference's fallback, logged here
            logging.warning("no tokenizer loaded from %s (%s: %s); using TinyTokenizer",
                            target, type(e).__name__, e)
    return TinyTokenizer()


def _sub(path: Optional[str], name: str) -> Optional[str]:
    """A diffusers subfolder of `path` if it exists, else `path` itself."""
    if path is None:
        return None
    p = os.path.join(path, name)
    return p if os.path.exists(p) else path


def pipeline_parts(kind: str, *, device, dtype: torch.dtype = torch.bfloat16):
    """{diffusers subfolder: (module, rule set)} of a full-size pipeline:
    'sd15' (CLIP ViT-L/14 text, the SD-1.5 UNet, the SD VAE), 'zeroscope'
    (CLIP ViT-H/14, the 1.4B UNet3D, the SD VAE), 'audioldm' (CLAP text, the
    AudioLDM-l UNet with its class embedding, the mel VAE, and the HiFi-GAN
    vocoder, in fp32 as the reference computes it), 'sdxl_story' (CLIP ViT-L/14
    and OpenCLIP bigG text, the SDXL UNet, the SDXL VAE). Modules in `dtype`,
    their weights as constructed."""
    from spider_tpu_torch.models.clip_text import (ClapTextConfig, ClapTextModel,
                                                   CLIPTextModel, clip_vit_h14, clip_vit_l14,
                                                   open_clip_bigg)
    from spider_tpu_torch.models.unet2d import (UNet2DConditionModel, unet_audioldm,
                                                unet_sd15, unet_sdxl)
    from spider_tpu_torch.models.unet3d import UNet3DConditionModel, unet3d_zeroscope
    from spider_tpu_torch.models.vae import AutoencoderKL, vae_audioldm, vae_sd, vae_sdxl
    from spider_tpu_torch.models.vocoder import HifiGan, hifigan_audioldm

    def rep(cfg):
        return dataclasses.replace(cfg, dtype=dtype)

    if kind == "sd15":
        return {"text_encoder": (CLIPTextModel(rep(clip_vit_l14()), device), C.clip_text_rules),
                "unet": (UNet2DConditionModel(rep(unet_sd15()), device), C.unet2d_rules),
                "vae": (AutoencoderKL(rep(vae_sd()), device), C.vae_rules)}
    if kind == "zeroscope":
        return {"text_encoder": (CLIPTextModel(rep(clip_vit_h14()), device), C.clip_text_rules),
                "unet": (UNet3DConditionModel(rep(unet3d_zeroscope()), device), C.unet3d_rules),
                "vae": (AutoencoderKL(rep(vae_sd()), device), C.vae_rules)}
    if kind == "audioldm":
        tcfg = rep(ClapTextConfig())
        # The cross-attention context is the CLAP vector itself, so its
        # width is the CLAP projection width (pipelines/ad.py).
        ucfg = dataclasses.replace(unet_audioldm(), dtype=dtype,
                                   cross_attention_dim=tcfg.projection_dim,
                                   addition_embed_type="class_embed",
                                   projection_class_embeddings_input_dim=tcfg.projection_dim)
        return {"text_encoder": (ClapTextModel(tcfg, device), C.clap_text_rules),
                "unet": (UNet2DConditionModel(ucfg, device), C.unet2d_rules),
                "vae": (AutoencoderKL(rep(vae_audioldm()), device), C.vae_rules),
                "vocoder": (HifiGan(hifigan_audioldm(), device), C.hifigan_rules)}
    if kind == "sdxl_story":
        return {"text_encoder": (CLIPTextModel(rep(clip_vit_l14()), device), C.clip_text_rules),
                "text_encoder_2": (CLIPTextModel(rep(open_clip_bigg()), device),
                                   C.clip_text_rules),
                "unet": (UNet2DConditionModel(rep(unet_sdxl()), device), C.unet2d_rules),
                "vae": (AutoencoderKL(rep(vae_sdxl()), device), C.vae_rules)}
    raise ValueError(f"no pipeline kind {kind!r} (expected 'sd15', 'zeroscope', 'audioldm' "
                     f"or 'sdxl_story')")


def from_pretrained(kind: str, path: Optional[str] = None, *, device,
                    dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                    quantization: str = "int8"):
    """Full-size model on `device`: random from `seed` without `path`; with
    `path`, the checkpoint there, streamed onto the device (an HF/diffusers
    directory or a single .safetensors/.bin/.pth file).

    kinds: 'sd15' -> StableDiffusionPipeline at 512px, 'zeroscope' ->
    TextToVideoSDPipeline at 576x320, 'audioldm' -> AudioLDMPipeline,
    'sdxl_story' -> StoryXLPipeline at 768px (``pipeline_parts`` has their
    modules; a checkpoint is read from its ``text_encoder``,
    ``text_encoder_2``, ``unet``, ``vae`` and ``vocoder`` subfolders, the
    tokenizers from ``tokenizer`` and ``tokenizer_2``); 'llama' -> (LlamaForCausalLM 8B with
    `quantization` 'int8' or 'int4' projections, tokenizer): from a
    checkpoint, its config.json gives the shape and the projections quantise
    to int8, as the reference's from_pretrained does; 'imagebind' ->
    ImageBindEncoder (imagebind_huge) in `dtype`; 'sam' -> Sam (ViT-H at
    1024px) in `dtype`, from the official ``sam_vit_h`` checkpoint;
    'grounding_dino' -> GroundingDINOInference (Swin-T + BERT-base, 900
    queries, at 512px) in `dtype`, from an mm_grounding_dino checkpoint. A
    checkpoint's tokenizer is its HF tokenizer through ``transformers``, or
    TinyTokenizer where that cannot load (``_hf_tokenizer``); a random
    Grounding DINO takes TinyTokenizer.
    """
    if kind == "llama":
        if quantization not in ("int8", "int4"):
            raise ValueError(f"llama quantization must be 'int8' or 'int4', got "
                             f"{quantization!r}")
        if path is None:
            return (build_llama(llama3_8b_quantized(quantization), device, seed),
                    TinyTokenizer())
        if quantization != "int8":
            raise NotImplementedError("a checkpoint loads with int8 projections only, as "
                                      "the reference's from_pretrained does")
        _, model = C.convert_llama_checkpoint(path, "int8", device=device,
                                              param_dtype=torch.bfloat16)
        return model, _hf_tokenizer(path, "")
    if kind == "imagebind":
        from spider_tpu_torch.models.imagebind import ImageBindEncoder, imagebind_huge

        model = ImageBindEncoder(dataclasses.replace(imagebind_huge(), dtype=dtype),
                                 device).eval()
        if path is None:
            return random_init_(model, torch.Generator(device=device).manual_seed(seed))
        return C.load_checkpoint(model, C.imagebind_rules, path)
    if kind == "sam":
        from spider_tpu_torch.models.sam import Sam, sam_vit_h

        model = Sam(dataclasses.replace(sam_vit_h(), dtype=dtype), device).eval()
        if path is None:
            return random_init_(model, torch.Generator(device=device).manual_seed(seed))
        return C.load_checkpoint(model, C.sam_rules, path)
    if kind == "grounding_dino":
        from spider_tpu_torch.models.dino import (GroundingDINO, GroundingDINOInference,
                                                  grounding_dino_tiny, with_dtype)

        model = GroundingDINO(with_dtype(grounding_dino_tiny(), dtype), device).eval()
        if path is None:
            random_init_(model, torch.Generator(device=device).manual_seed(seed))
            return GroundingDINOInference(model, TinyTokenizer())
        C.load_checkpoint(model, C.grounding_dino_rules, path)
        return GroundingDINOInference(model, _hf_tokenizer(path, ""))
    if kind not in ("sd15", "zeroscope", "audioldm", "sdxl_story"):
        raise ValueError(f"unknown kind {kind!r} (expected 'sd15', 'zeroscope', 'audioldm', "
                         f"'sdxl_story', 'imagebind', 'sam', 'grounding_dino' or 'llama')")
    parts = pipeline_parts(kind, device=device, dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    for sub, (module, rules) in parts.items():
        module.eval()
        if path is None:
            random_init_(module, gen)
        else:
            C.load_checkpoint(module, rules, _sub(path, sub))
    tok = _hf_tokenizer(path) if path is not None else TinyTokenizer()
    mods = [module for module, _ in parts.values()]
    if kind == "sd15":
        from spider_tpu_torch.models.pipelines.sd import StableDiffusionPipeline

        return StableDiffusionPipeline(tok, *mods, height=512, width=512)
    if kind == "sdxl_story":
        from spider_tpu_torch.models.pipelines.sdxl_story import StoryXLPipeline

        tok2 = _hf_tokenizer(path, "tokenizer_2") if path is not None else tok
        return StoryXLPipeline(tok, tok2, *mods, height=768, width=768)
    if kind == "zeroscope":
        from spider_tpu_torch.models.pipelines.vd import TextToVideoSDPipeline

        return TextToVideoSDPipeline(tok, *mods)
    from spider_tpu_torch.models.pipelines.ad import AudioLDMPipeline

    return AudioLDMPipeline(tok, *mods, mel_bins=64)


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
    sam = None
    if with_sam:
        from spider_tpu_torch.models.sam import Sam, sam_tiny

        sam = random_init_(Sam(sam_tiny(), device), gen)
    # alignment dims follow the pipes' conditioning spaces and SAM's prompt space
    align_specs = {
        "IMAGE": dict(alignment_input_tokens=modality_tokens["IMAGE"],
                      alignment_output_tokens=77, alignment_output_dim=32),
        "VIDEO": dict(alignment_input_tokens=modality_tokens["VIDEO"],
                      alignment_output_tokens=77, alignment_output_dim=32),
        "AUDIO": dict(alignment_input_tokens=modality_tokens["AUDIO"],
                      alignment_output_tokens=1, alignment_output_dim=16),
        "MASK": dict(alignment_input_tokens=1, alignment_output_tokens=1,
                     alignment_output_dim=sam.config.prompt_embed_dim if sam else 8),
    }
    aligners, moe = _build_aligners(cfg.hidden_size, align_specs, use_moe_aligner, 32, 1,
                                    device, gen)
    return Spider(llm=llm, tokenizer=tokenizer, encoder=encoder,
                  llama_proj=_llama_proj(ib_cfg.embed_dim, cfg.hidden_size, device, gen),
                  aligners=aligners, moe_aligner=moe, diffusion_pipes=pipes, sam=sam,
                  modality_tokens=modality_tokens, max_context_len=max_context_len,
                  **spider_kwargs)


def build_full_spider(*, device, paths: Optional[Dict[str, str]] = None, seed: int = 0,
                      dtype: torch.dtype = torch.bfloat16, lora_r: int = 32,
                      with_encoder: bool = True, with_sam: bool = False,
                      with_pipes: bool = False, use_moe_aligner: bool = True,
                      max_context_len: int = 500, remat: bool = True,
                      diffusion_pipes: Optional[Dict] = None, **spider_kwargs):
    """Full-size trainable Spider at the reference operating point: frozen
    ImageBind-huge encoder -> input projection -> LoRA-r32 Llama-3-8B
    architecture with the extended signal-token vocabulary ->
    moe_transformer aligners (hidden 512, 3 experts x 4+4 layers; dims per
    FULL_ALIGN_SPECS).

    paths: checkpoint directories or files by component ('llama',
    'imagebind', 'sam', 'sd15', 'zeroscope', 'audioldm'); a component
    without one is random from `seed`. The llama
    checkpoint gives the base weights (its config.json the shape) and keeps
    them unquantised; its vocabulary grows by ``extend_embedding_rows``,
    the reference's new rows. The LoRA pairs, the aligner and the input
    projection keep their random init, as the reference grafts them.

    One-card operating point: the base Llama weights are stored in `dtype`
    and frozen (no gradient, no optimizer state); what trains is fp32: the
    LoRA pairs, ``embed_tokens`` and ``lm_head`` (whose first rows, the base
    vocabulary, the optimizer freezes: ``num_frozen_embed_rows``), the input
    projection, the aligner and ``logit_scale``. ``remat`` recomputes each of
    the blocks in the backward pass. Vocabulary: with TinyTokenizer (no
    checkpoint, or one whose tokenizer cannot load: ``_hf_tokenizer``) the
    base vocabulary (128256 for llama3_8b) + the tokenizer's, rounded up to a
    multiple of 128, so the signal tokens' rows are new rows; with the
    checkpoint's HF tokenizer, as the reference has it, its length rounded up
    to a multiple of 128, or the base vocabulary if that is larger.

    with_pipes builds resident SD-1.5 / ZeroScope / AudioLDM pipelines for the
    alignment targets; `diffusion_pipes` hands over pipelines already built.
    with_sam builds SAM ViT-H in `dtype` (``from_pretrained('sam')``) for
    the MASK branch: Spider freezes its image and prompt encoders, and its
    mask decoder trains with fp32 parameters, computing in `dtype`.
    """
    from spider_tpu_torch.models.spider import Spider

    paths = {k: v for k, v in (paths or {}).items() if v}
    unknown = set(paths) - {"llama", "imagebind", "sam", "sd15", "zeroscope", "audioldm"}
    if unknown:
        raise ValueError(f"unknown checkpoint path(s) {sorted(unknown)}")
    if "sam" in paths and not with_sam:
        raise ValueError("paths['sam'] is given but with_sam is False")
    gen = torch.Generator(device=device).manual_seed(seed)
    llama_path = paths.get("llama")
    tokenizer = _hf_tokenizer(llama_path, "") if llama_path else TinyTokenizer()
    modality_tokens = {"IMAGE": 1, "VIDEO": 1, "AUDIO": 1, "MASK": 1, "BOX": 1}
    extend_tokenizer(tokenizer, modality_tokens, bbox_bins=0)
    base = C.read_llama_config(llama_path) if llama_path else L.llama3_8b()
    if isinstance(tokenizer, TinyTokenizer):
        new_vocab = -(-(base.vocab_size + len(tokenizer)) // 128) * 128
    else:
        new_vocab = max(-(-len(tokenizer) // 128) * 128, base.vocab_size)
    cfg = dataclasses.replace(base, vocab_size=new_vocab, lora=L.LoraConfig(r=lora_r),
                              dtype=dtype, param_dtype=dtype, remat=remat)
    llm = random_init_(L.LlamaForCausalLM(cfg, device), gen)
    llm.requires_grad_(False)
    lora = set()
    for name, p in llm.named_parameters():
        if name.endswith(("lora_a", "lora_b")):
            p.requires_grad_(True)
            lora.add(name)
    for mod in (llm.embed_tokens, llm.lm_head):       # new rows train, in fp32
        mod.weight = nn.Parameter(mod.weight.detach().float())
    if llama_path:
        def grow(name, t):
            if name in ("embed_tokens.weight", "lm_head.weight"):
                return C.extend_embedding_rows(name, t, new_vocab)
            return t

        C.load_checkpoint(llm, C.llama_rules, llama_path, skip=lora, hook=grow)

    encoder = None
    if with_encoder:
        encoder = from_pretrained("imagebind", paths.get("imagebind"), device=device,
                                  dtype=dtype, seed=seed)
    sam = None
    if with_sam:
        sam = from_pretrained("sam", paths.get("sam"), device=device, dtype=dtype, seed=seed)
        sam.mask_decoder.float()
    aligners, moe = _build_aligners(cfg.hidden_size, FULL_ALIGN_SPECS, use_moe_aligner, 512,
                                    4, device, gen)
    pipes = dict(diffusion_pipes or {})
    if with_pipes:
        for m, kind in (("IMAGE", "sd15"), ("VIDEO", "zeroscope"), ("AUDIO", "audioldm")):
            if m not in pipes:
                pipes[m] = from_pretrained(kind, paths.get(kind), device=device, dtype=dtype,
                                           seed=seed)
    return Spider(llm=llm, tokenizer=tokenizer, encoder=encoder,
                  llama_proj=_llama_proj(1024, cfg.hidden_size, device, gen),
                  aligners=aligners, moe_aligner=moe, diffusion_pipes=pipes, sam=sam,
                  modality_tokens=modality_tokens, max_context_len=max_context_len,
                  **spider_kwargs)


def build_spider_from_config(model_config: Dict, *, device):
    """Config blob -> Spider on `device`. preset='tiny' builds the test-scale
    model (random weights; it takes no checkpoint paths), 'full' the
    full-width one, loading the checkpoints ``paths`` names."""
    cfg = dict(model_config)
    preset = cfg.pop("preset", "tiny")
    if preset == "tiny":
        if any(cfg.get("paths", {}).values()):
            raise ValueError("preset 'tiny' is random and takes no checkpoint paths")
        keys = ("use_moe_aligner", "with_pipes", "modality_tokens", "lora_r") + _SPIDER_KWARGS
        return build_tiny_spider(device=device, **{k: cfg[k] for k in keys if k in cfg})
    if preset == "full":
        keys = ("paths", "lora_r", "with_encoder", "with_sam", "with_pipes",
                "use_moe_aligner") + _SPIDER_KWARGS
        return build_full_spider(device=device, **{k: cfg[k] for k in keys if k in cfg})
    raise ValueError(f"unknown spider preset {preset!r} (expected 'tiny' or 'full')")
