"""Random-init builders of the slice's full-size models on an explicit
device, from a seeded ``torch.Generator`` (counterpart of the random-init
branch of spider_tpu/models/factory.py::from_pretrained). Weight values do
not change the work a forward pass does; real weights load through
spider_tpu/models/convert.py and ``convert.load_jax_params``.
"""

from __future__ import annotations

import dataclasses
import torch
from torch import nn

from spider_tpu_torch.models import llama as L
from spider_tpu_torch.models.tokenizer import TinyTokenizer

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
    effective spread as a float one."""
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
    raise ValueError(f"unknown kind {kind!r} (expected 'sd15', 'zeroscope', 'audioldm' "
                     f"or 'llama')")
