"""Text-to-video pipeline (ZeroScope class) in PyTorch (counterpart of
spider_tpu/models/pipelines/vd.py).

Tokenizing, prompt encoding and the CFG DDIM loop are the SD pipeline's, run
on a [B, F, h, w, 4] latent volume through the UNet3D. The frames are
decoded through the 2-D VAE in one batched call, with frames folded into the
batch, and come back as uint8. As in the reference, the initial latents are
drawn without ``init_noise_sigma`` (1.0 for DDIM either way).

Left out: the mesh-sharded denoise (``_denoise_fn_sharded``), which needs
more than one card.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from spider_tpu_torch.common.registry import registry
from spider_tpu_torch.models.clip_text import CLIPTextModel
from spider_tpu_torch.models.pipelines.sd import StableDiffusionPipeline
from spider_tpu_torch.models.schedulers import DDIMScheduler
from spider_tpu_torch.models.unet3d import UNet3DConditionModel
from spider_tpu_torch.models.vae import AutoencoderKL


@registry.register_model("vd")
class TextToVideoSDPipeline(StableDiffusionPipeline):
    def __init__(self, tokenizer, text_encoder: CLIPTextModel, unet: UNet3DConditionModel,
                 vae: AutoencoderKL, scheduler: Optional[DDIMScheduler] = None):
        super().__init__(tokenizer, text_encoder, unet, vae, scheduler, height=320, width=576)

    @torch.inference_mode()
    def _decode_latents(self, latents: torch.Tensor) -> np.ndarray:
        """[B, F, h, w, 4] latents -> uint8 frames [B, F, H, W, 3]: one VAE
        call over all frames, then the reference's scaling in the VAE's
        dtype and a truncating cast."""
        B, F = latents.shape[:2]
        img = self.vae.decode(latents.reshape(B * F, *latents.shape[2:]))
        frames = ((img / 2 + 0.5).clamp(0.0, 1.0) * 255.0).to(torch.uint8)
        return frames.cpu().numpy().reshape(B, F, *frames.shape[1:])

    def __call__(self, prompt: Optional[Sequence[str]] = None,
                 prompt_embeds: Optional[torch.Tensor] = None,
                 negative_prompt: Optional[Sequence[str]] = None,
                 guidance_scale: float = 7.5, num_inference_steps: int = 40,
                 height: int = 320, width: int = 576, num_frames: int = 16,
                 return_prompts_only: bool = False,
                 generator: Optional[torch.Generator] = None, eta: float = 0.0,
                 latents: Optional[torch.Tensor] = None) -> np.ndarray:
        """-> uint8 numpy [B, F, H, W, 3]. `latents` [B,F,h,w,4] replaces the
        initial noise drawn from `generator` (seeded with 0 when absent)."""
        if return_prompts_only:
            assert prompt is not None
            return self.encode_prompt(prompt)
        if prompt_embeds is None:
            assert prompt is not None
            prompt_embeds = self.encode_prompt(prompt)
        B = prompt_embeds.shape[0]
        if negative_prompt is None:
            negative_prompt = [""] * B
        uncond = self.encode_prompt(negative_prompt)
        factor = 2 ** (len(self.vae.config.block_out_channels) - 1)
        lat_shape = (B, num_frames, height // factor, width // factor,
                     self.unet.config.in_channels)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        if latents is None:
            latents = torch.randn(lat_shape, generator=generator, dtype=torch.float32,
                                  device=self.device)
        latents = latents.to(device=self.device, dtype=torch.float32)
        run = self._denoise_fn(num_inference_steps, guidance_scale, lat_shape, eta=float(eta))
        latents = run(latents, prompt_embeds.float(), uncond.float(), generator)
        return self._decode_latents(latents)


def build_tiny_vd(tokenizer=None, *, device, seed: int = 0) -> TextToVideoSDPipeline:
    """Random-init tiny pipeline (CPU tests / offline demos)."""
    from spider_tpu_torch.models.clip_text import clip_tiny
    from spider_tpu_torch.models.factory import random_init_
    from spider_tpu_torch.models.tokenizer import TinyTokenizer
    from spider_tpu_torch.models.unet3d import unet3d_tiny
    from spider_tpu_torch.models.vae import vae_tiny

    tokenizer = tokenizer or TinyTokenizer()
    gen = torch.Generator(device=device).manual_seed(seed)
    tcfg = clip_tiny(vocab_size=max(len(tokenizer), 300))
    text = random_init_(CLIPTextModel(tcfg, device), gen)
    unet = random_init_(UNet3DConditionModel(
        unet3d_tiny(cross_attention_dim=tcfg.hidden_size), device), gen)
    vae = random_init_(AutoencoderKL(vae_tiny(), device), gen)
    return TextToVideoSDPipeline(tokenizer, text, unet, vae)
