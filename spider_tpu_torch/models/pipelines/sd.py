"""Stable-Diffusion-1.5-class text-to-image pipeline in PyTorch (counterpart
of spider_tpu/models/pipelines/sd.py).

The CFG denoise loop is a Python loop over the DDIM timesteps with the
UNet run on the concatenated [uncond, cond] batch; the models stay resident
on their device. Initial latents come from a ``torch.Generator`` (or are
passed in), so they differ from the JAX pipeline's ``jax.random`` latents
for the same seed; parity is checked with injected latents.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from spider_tpu_torch.common.profiler import span
from spider_tpu_torch.common.registry import registry
from spider_tpu_torch.models.clip_text import CLIPTextModel
from spider_tpu_torch.models.schedulers import DDIMScheduler
from spider_tpu_torch.models.unet2d import UNet2DConditionModel
from spider_tpu_torch.models.vae import AutoencoderKL


def pad_ids(ids: Sequence[int], length: int, pad_id: int) -> List[int]:
    ids = list(ids)[:length]
    return ids + [pad_id] * (length - len(ids))


@registry.register_model("sd")
class StableDiffusionPipeline:
    """Text encoder + UNet + VAE with a CFG denoise loop."""

    def __init__(self, tokenizer, text_encoder: CLIPTextModel, unet: UNet2DConditionModel,
                 vae: AutoencoderKL, scheduler: Optional[DDIMScheduler] = None,
                 height: int = 512, width: int = 512):
        self.tokenizer = tokenizer
        self.text_encoder = text_encoder
        self.unet = unet
        self.vae = vae
        self.scheduler = scheduler or DDIMScheduler()
        self.height = height
        self.width = width

    @property
    def device(self) -> torch.device:
        return self.text_encoder.token_embedding.weight.device

    # ------------------------------------------------------------------ text
    def tokenize(self, prompts: Sequence[str]) -> torch.Tensor:
        max_len = self.text_encoder.config.max_position_embeddings
        eos = getattr(self.tokenizer, "eos_token_id", 0)
        batch = []
        for p in prompts:
            ids = self.tokenizer(p, add_special_tokens=True).input_ids
            ids = list(ids)[: max_len - 1] + [eos]
            batch.append(pad_ids(ids, max_len, eos))
        return torch.tensor(batch, dtype=torch.long, device=self.device)

    @torch.inference_mode()
    def encode_prompt(self, prompts: Sequence[str]) -> torch.Tensor:
        """Text-conditioning embeddings [B, 77, D]."""
        with span("pipeline.text_encode"):
            return self.text_encoder(self.tokenize(prompts))[0]

    # --------------------------------------------------------------- denoise
    def _denoise_fn(self, num_steps: int, guidance_scale: float, shape, eta: float = 0.0):
        """run(latents, cond, uncond, generator=None) -> latents: the CFG
        DDIM loop for one (steps, scale, eta); latents [B,h,w,C] fp32 of
        `shape`. Eager PyTorch compiles nothing, so unlike the JAX pipeline
        nothing is cached per shape."""
        sched = self.scheduler
        timesteps = sched.timesteps(num_steps)

        @torch.inference_mode()
        def run(latents, cond, uncond, generator=None):
            if tuple(latents.shape) != tuple(shape):
                raise ValueError(f"latents {tuple(latents.shape)} vs shape {tuple(shape)}")
            with span("pipeline.denoise"):
                context = torch.cat([uncond, cond], dim=0)
                for i, t in enumerate(timesteps):
                    with span("pipeline.step", i=i):
                        lat_in = torch.cat([latents, latents], dim=0)
                        tt = torch.full((lat_in.shape[0],), t, dtype=torch.int32,
                                        device=latents.device)
                        eps_u, eps_c = self.unet(lat_in, tt, context).chunk(2, dim=0)
                        eps = eps_u + guidance_scale * (eps_c - eps_u)
                        noise = None
                        if eta > 0.0:
                            if generator is None:
                                raise ValueError("eta > 0 needs an explicit torch.Generator")
                            noise = torch.randn(latents.shape, generator=generator,
                                                dtype=torch.float32, device=latents.device)
                        latents = sched.step(eps, t, latents, num_steps, eta=eta, noise=noise)
            return latents

        return run

    @torch.inference_mode()
    def _decode_latents(self, latents: torch.Tensor) -> np.ndarray:
        with span("pipeline.vae_decode"):
            img = (self.vae.decode(latents) / 2 + 0.5).clamp(0.0, 1.0)
            return img.float().cpu().numpy()

    # ------------------------------------------------------------------ call
    def __call__(self, prompt: Optional[Sequence[str]] = None,
                 prompt_embeds: Optional[torch.Tensor] = None,
                 negative_prompt: Optional[Sequence[str]] = None,
                 guidance_scale: float = 7.5, num_inference_steps: int = 40,
                 return_prompts_only: bool = False,
                 generator: Optional[torch.Generator] = None,
                 height: Optional[int] = None, width: Optional[int] = None,
                 eta: float = 0.0, latents: Optional[torch.Tensor] = None) -> np.ndarray:
        """-> [B, H, W, 3] float32 numpy in [0, 1]. `latents` [B,h,w,C]
        replaces the initial noise drawn from `generator`; with neither, a
        generator seeded with 0 draws it (the JAX pipeline defaults to
        PRNGKey(0))."""
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
        height = height or self.height
        width = width or self.width
        factor = 2 ** (len(self.vae.config.block_out_channels) - 1)
        lat_shape = (B, height // factor, width // factor, self.unet.config.in_channels)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        if latents is None:
            latents = torch.randn(lat_shape, generator=generator, dtype=torch.float32,
                                  device=self.device) * self.scheduler.init_noise_sigma
        latents = latents.to(device=self.device, dtype=torch.float32)
        run = self._denoise_fn(num_inference_steps, guidance_scale, lat_shape,
                               eta=float(eta))
        latents = run(latents, prompt_embeds.float(), uncond.float(), generator)
        return self._decode_latents(latents)


def build_tiny_sd(tokenizer=None, *, device, seed: int = 0) -> StableDiffusionPipeline:
    """Random-init tiny pipeline (CPU tests / offline demos)."""
    from spider_tpu_torch.models.clip_text import clip_tiny
    from spider_tpu_torch.models.factory import random_init_
    from spider_tpu_torch.models.tokenizer import TinyTokenizer
    from spider_tpu_torch.models.unet2d import unet_tiny
    from spider_tpu_torch.models.vae import vae_tiny

    tokenizer = tokenizer or TinyTokenizer()
    gen = torch.Generator(device=device).manual_seed(seed)
    tcfg = clip_tiny(vocab_size=max(len(tokenizer), 300))
    text = random_init_(CLIPTextModel(tcfg, device), gen)
    unet = random_init_(UNet2DConditionModel(unet_tiny(cross_attention_dim=tcfg.hidden_size),
                                             device), gen)
    vae = random_init_(AutoencoderKL(vae_tiny(), device), gen)
    return StableDiffusionPipeline(tokenizer, text, unet, vae, height=16, width=16)
