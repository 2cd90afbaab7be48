"""Text-to-video pipeline (ZeroScope class) in PyTorch (counterpart of
spider_tpu/models/pipelines/vd.py).

Tokenizing, prompt encoding and the CFG DDIM loop are the SD pipeline's, run
on a [B, F, h, w, 4] latent volume through the UNet3D. The frames are
decoded through the 2-D VAE in one batched call, with frames folded into the
batch, and come back as uint8. As in the reference, the initial latents are
drawn without ``init_noise_sigma`` (1.0 for DDIM either way).

Over a (cfg, sp) mesh (``common.dist.make_video_mesh``; ``__call__(mesh=)``)
the denoise is sharded as the reference's ``_denoise_fn_sharded`` places it:
the CFG pair [uncond, cond] is split over ``cfg`` (with cfg 2, rank 0 the
unconditional half and rank 1 the conditional one; with cfg 1 a rank holds
the pair, as the one-process loop does) and the frames over ``sp`` (F % sp
== 0); each step joins the pair's noise predictions over ``cfg`` for the
guidance and takes the DDIM step on the rank's own frames. The UNet3D's
temporal layers do the frame split's collectives (models/unet3d.py). The
decode spreads the B*F frames over all cfg*sp ranks, and every rank gets the
whole uint8 video back.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from spider_tpu_torch.common.profiler import span
from spider_tpu_torch.common.registry import registry
from spider_tpu_torch.models.clip_text import CLIPTextModel
from spider_tpu_torch.parallel.collectives import gather, group_of, rank_in, size_of
from spider_tpu_torch.models.pipelines.sd import StableDiffusionPipeline
from spider_tpu_torch.models.schedulers import DDIMScheduler
from spider_tpu_torch.models.unet3d import UNet3DConditionModel
from spider_tpu_torch.models.vae import AutoencoderKL


@registry.register_model("vd")
class TextToVideoSDPipeline(StableDiffusionPipeline):
    def __init__(self, tokenizer, text_encoder: CLIPTextModel, unet: UNet3DConditionModel,
                 vae: AutoencoderKL, scheduler: Optional[DDIMScheduler] = None):
        super().__init__(tokenizer, text_encoder, unet, vae, scheduler, height=320, width=576)

    def _to_uint8(self, flat: torch.Tensor) -> torch.Tensor:
        """[N, h, w, 4] latents -> uint8 frames [N, H, W, 3]: one VAE call,
        then the reference's scaling in the VAE's dtype and a truncating
        cast."""
        img = self.vae.decode(flat)
        return ((img / 2 + 0.5).clamp(0.0, 1.0) * 255.0).to(torch.uint8)

    @torch.inference_mode()
    def _decode_latents(self, latents: torch.Tensor) -> np.ndarray:
        """[B, F, h, w, 4] latents -> uint8 frames [B, F, H, W, 3], all
        frames in one VAE call."""
        B, F = latents.shape[:2]
        with span("pipeline.vae_decode"):
            frames = self._to_uint8(latents.reshape(B * F, *latents.shape[2:]))
            return frames.cpu().numpy().reshape(B, F, *frames.shape[1:])

    def _denoise_fn_sharded(self, num_steps: int, guidance_scale: float, shape, mesh):
        """run(latents, cond, uncond) -> latents: the CFG DDIM loop (eta 0)
        over the (cfg, sp) `mesh`, every rank given the whole [B,F,h,w,C]
        latents of `shape` and both embeddings, every rank getting the whole
        result back. Raises ValueError where F does not split over sp or the
        2B rows of the pair over cfg."""
        sched = self.scheduler
        timesteps = sched.timesteps(num_steps)
        cfg_group, sp_group = group_of(mesh, ("cfg",)), group_of(mesh, ("sp",))
        n_cfg, n_sp = size_of(cfg_group), size_of(sp_group)
        B, Fr = shape[:2]
        if Fr % n_sp:
            raise ValueError(f"{Fr} frames do not split over sp = {n_sp} ranks")
        if (2 * B) % n_cfg:
            raise ValueError(f"the CFG pair's {2 * B} rows do not split over cfg = {n_cfg} ranks")
        rows = 2 * B // n_cfg
        pair = slice(rank_in(cfg_group) * rows, (rank_in(cfg_group) + 1) * rows)
        fl = Fr // n_sp
        frames = slice(rank_in(sp_group) * fl, (rank_in(sp_group) + 1) * fl)

        @torch.inference_mode()
        def run(latents, cond, uncond):
            if tuple(latents.shape) != tuple(shape):
                raise ValueError(f"latents {tuple(latents.shape)} vs shape {tuple(shape)}")
            with span("pipeline.denoise"):
                context = torch.cat([uncond, cond], dim=0)[pair]
                latents = latents[:, frames]
                for i, t in enumerate(timesteps):
                    with span("pipeline.step", i=i):
                        lat_in = torch.cat([latents, latents], dim=0)[pair]
                        tt = torch.full((rows,), t, dtype=torch.int32, device=latents.device)
                        eps = self.unet(lat_in, tt, context, sp_group=sp_group)
                        eps_u, eps_c = gather(eps, cfg_group, 0).chunk(2, dim=0)
                        eps = eps_u + guidance_scale * (eps_c - eps_u)
                        latents = sched.step(eps, t, latents, num_steps)
                return gather(latents, sp_group, 1)

        return run

    @torch.inference_mode()
    def _decode_latents_sharded(self, latents: torch.Tensor, mesh) -> np.ndarray:
        """``_decode_latents`` with the B*F frames spread over every rank of
        the (cfg, sp) `mesh` (rank c*sp + s the block c*sp + s of
        ceil(B*F / n) frames) and the uint8 frames gathered on every rank."""
        group = group_of(mesh, ("cfg", "sp"))
        n, r = size_of(group), rank_in(group)
        B, Fr = latents.shape[:2]
        flat = latents.reshape(B * Fr, *latents.shape[2:])
        per = -(-(B * Fr) // n)
        mine = flat[r * per:(r + 1) * per]
        factor = 2 ** (len(self.vae.config.block_out_channels) - 1)
        H, W = flat.shape[1] * factor, flat.shape[2] * factor
        with span("pipeline.vae_decode"):
            out = torch.zeros((per, H, W, 3), dtype=torch.uint8, device=flat.device)
            if mine.shape[0]:
                out[:mine.shape[0]] = self._to_uint8(mine)
            frames = gather(out, group, 0)[:B * Fr]
            return frames.cpu().numpy().reshape(B, Fr, H, W, 3)

    def __call__(self, prompt: Optional[Sequence[str]] = None,
                 prompt_embeds: Optional[torch.Tensor] = None,
                 negative_prompt: Optional[Sequence[str]] = None,
                 guidance_scale: float = 7.5, num_inference_steps: int = 40,
                 height: int = 320, width: int = 576, num_frames: int = 16,
                 return_prompts_only: bool = False,
                 generator: Optional[torch.Generator] = None, eta: float = 0.0,
                 latents: Optional[torch.Tensor] = None, mesh=None) -> np.ndarray:
        """-> uint8 numpy [B, F, H, W, 3]. `latents` [B,F,h,w,4] replaces the
        initial noise drawn from `generator` (seeded with 0 when absent).
        `mesh`: the (cfg, sp) DeviceMesh of a sharded call (eta 0 only); each
        of its ranks calls with the same arguments, the latents are taken
        from its first rank, and each rank gets the whole video back."""
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
        if mesh is not None:
            if eta != 0.0:
                raise ValueError("the sharded denoise takes eta 0 only")
            group = group_of(mesh, ("cfg", "sp"))
            if size_of(group) > 1:
                torch.distributed.broadcast(latents, torch.distributed.get_global_rank(group, 0),
                                            group=group)
            run = self._denoise_fn_sharded(num_inference_steps, guidance_scale, lat_shape, mesh)
            latents = run(latents, prompt_embeds.float(), uncond.float())
            return self._decode_latents_sharded(latents, mesh)
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
