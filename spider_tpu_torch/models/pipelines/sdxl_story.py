"""SDXL with StoryDiffusion's consistent self-attention in PyTorch
(counterpart of spider_tpu/models/pipelines/sdxl_story.py).

A two-text-encoder SDXL denoiser whose up-block self-attentions are coupled
across the batch: every image's self-attention keys and values are joined by
tokens sampled from the first ``id_length`` images at the same denoise step.
The id images and the story frames denoise jointly, in one batch: id rows see
only id tokens, story rows the id tokens and their own, which reproduces the
reference's write-then-read phases without a mutable id bank. The sampled
token indices are drawn once per request on the host, per up block, from
``np.random.default_rng(seed)`` in the JAX pipeline's order, so they are the
same indices.

The CFG denoise loop is a Python loop over the Euler steps; the models stay
resident on their device. Initial latents come from a ``torch.Generator`` on
the pipeline's device, so they differ from the JAX
pipeline's ``jax.random`` latents for the same seed; parity is checked at the
denoise loop with injected latents.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spider_tpu_torch.common.profiler import span
from spider_tpu_torch.common.registry import registry
from spider_tpu_torch.models.clip_text import CLIPTextModel
from spider_tpu_torch.models.pipelines.sd import pad_ids
from spider_tpu_torch.models.schedulers import EulerDiscreteScheduler
from spider_tpu_torch.models.unet2d import UNet2DConditionModel
from spider_tpu_torch.models.vae import AutoencoderKL

# Style templates: the style names of StoryDiffusion's utils/style_template.py
# (part of the system-prompt contract), with the JAX package's wording.
STYLE_TEMPLATES: Dict[str, Tuple[str, str]] = {
    "(No style)": ("{prompt}", ""),
    "Japanese Anime": (
        "anime artwork of {prompt}, anime style, vibrant colors, clean line art,"
        " studio anime, key visual, highly detailed",
        "photo, realistic, black and white, low quality, deformed",
    ),
    "Digital/Oil Painting": (
        "an oil painting of {prompt}, rich brush strokes, digital painting,"
        " dramatic lighting, highly detailed, artstation quality",
        "photo, photorealistic, low quality, blurry, text, watermark",
    ),
    "Photographic": (
        "cinematic photo of {prompt}, 35mm photograph, film grain, bokeh,"
        " professional, 4k, highly detailed",
        "drawing, painting, cartoon, anime, sketch, low quality, deformed",
    ),
    "Comic book": (
        "comic book panel of {prompt}, bold outlines, halftone shading,"
        " graphic novel illustration, vivid colors",
        "photograph, realistic, 3d render, low quality, blurry",
    ),
}
DEFAULT_STYLE = "Japanese Anime"


def apply_style(style_name: str, prompts: Sequence[str],
                negative: str = "") -> Tuple[List[str], str]:
    pos, neg = STYLE_TEMPLATES.get(style_name, STYLE_TEMPLATES[DEFAULT_STYLE])
    return [pos.format(prompt=p) for p in prompts], (neg + " " + negative).strip()


def story_indices(cfg, id_length: int, lat_hw: Tuple[int, int], sa_ratio: float,
                  rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """{up block path: sorted int64 indices} into each group's flattened
    id-token bank: int(id_length * tokens * sa_ratio) distinct tokens (at
    least one) per transformer up block, the tokens those of the block's
    level. Draws from `rng` in the JAX pipeline's order."""
    out = {}
    h, w = lat_hw
    rev = list(reversed(cfg.block_out_channels))
    rev_attn = list(reversed(cfg.cross_attn_blocks))
    rev_depth = list(reversed(cfg.transformer_layers_per_block))
    for i in range(len(rev)):
        scale = 2 ** (len(rev) - 1 - i)          # up level i: the mid resolution * 2^i
        total = id_length * (h // scale) * (w // scale)
        count = max(1, int(total * sa_ratio))
        for j in range(cfg.layers_per_block + 1):
            if rev_attn[i] and rev_depth[i] > 0:
                idx = rng.choice(total, size=count, replace=False)
                out[f"up_{i}_attn_{j}"] = np.sort(idx).astype(np.int64)
    return out


@registry.register_model("sdxl_story")
class StoryXLPipeline:
    """SDXL with optional consistent self-attention over the batch."""

    def __init__(self, tokenizer, tokenizer_2, text_encoder: CLIPTextModel,
                 text_encoder_2: CLIPTextModel, unet: UNet2DConditionModel,
                 vae: AutoencoderKL, scheduler: Optional[EulerDiscreteScheduler] = None,
                 height: int = 768, width: int = 768, batched_cfg: bool = True):
        self.tokenizer = tokenizer
        self.tokenizer_2 = tokenizer_2
        self.text_encoder = text_encoder
        self.text_encoder_2 = text_encoder_2
        self.unet = unet
        self.vae = vae
        self.scheduler = scheduler or EulerDiscreteScheduler()
        self.height = height
        self.width = width
        # CFG in the denoise loop: batched runs uncond and cond as ONE [2B]
        # UNet call a step (two consistency groups), one weight read a step;
        # split (batched_cfg=False) runs two [B] calls, half the activations.
        # Batched on every device: at 768px with 4 frames it takes 9.24
        # steps/s against split's 7.05, at 16.4 against 16.1 GB peak
        # (chip_smoke.py story; NVIDIA H100 80GB HBM3, 700 W).
        self.batched_cfg = batched_cfg
        self._denoise_cache: Dict[Tuple, Callable] = {}

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    # ------------------------------------------------------------------ text
    def _tokenize(self, tokenizer, prompts, max_len: int, eos: int) -> torch.Tensor:
        batch = []
        for p in prompts:
            ids = list(tokenizer(p, add_special_tokens=True).input_ids)
            ids = ids[: max_len - 1] + [eos]
            batch.append(pad_ids(ids, max_len, eos))
        return torch.tensor(batch, dtype=torch.long, device=self.device)

    def _encode(self, ids1: torch.Tensor, ids2: torch.Tensor):
        _, h1, _ = self.text_encoder(ids1)
        _, h2, pooled = self.text_encoder_2(ids2)
        return torch.cat([h1[-2], h2[-2]], dim=-1), pooled

    @torch.inference_mode()
    def encode_prompt(self, prompts: Sequence[str]):
        """SDXL conditioning: the penultimate hidden states of both encoders
        concatenated [B, 77, 768 + 1280] and the projected pooled output of
        encoder 2 [B, 1280]."""
        c1, c2 = self.text_encoder.config, self.text_encoder_2.config
        with span("pipeline.text_encode"):
            return self._encode(
                self._tokenize(self.tokenizer, prompts, c1.max_position_embeddings,
                               c1.eos_token_id),
                self._tokenize(self.tokenizer_2, prompts, c2.max_position_embeddings,
                               c2.eos_token_id))

    @torch.inference_mode()
    def encode_prompt_photomaker(self, prompts: Sequence[str], id_pixels: torch.Tensor,
                                 id_encoder, trigger_word: str = "img"):
        """PhotoMaker ref-image conditioning (StoryDiffusion "Using Ref
        Images"): trigger-word surgery on both tokenizers, encode, then fuse
        the id-image embeddings into the concatenated context at the
        duplicated class-token positions (models/photomaker.py)."""
        from spider_tpu_torch.models.photomaker import prompts_with_trigger

        c1, c2 = self.text_encoder.config, self.text_encoder_2.config
        n_id = int(id_pixels.shape[0])
        ids1, mask1 = prompts_with_trigger(self.tokenizer, prompts, trigger_word, n_id,
                                           c1.max_position_embeddings, c1.eos_token_id)
        ids2, mask2 = prompts_with_trigger(self.tokenizer_2, prompts, trigger_word, n_id,
                                           c2.max_position_embeddings, c2.eos_token_id)
        if not (mask1 == mask2).all():
            raise ValueError("the two tokenizers disagree on trigger positions")
        dev = self.device
        with span("pipeline.text_encode"):
            ctx, pooled = self._encode(torch.from_numpy(ids1).long().to(dev),
                                       torch.from_numpy(ids2).long().to(dev))
            return id_encoder(id_pixels.to(dev), ctx, torch.from_numpy(mask1).to(dev)), pooled

    # --------------------------------------------------------------- denoise
    def _denoise_fn(self, num_steps: int, guidance_scale: float, shape, id_length: int,
                    story_shapes):
        """run(latents, ctx, pooled, uncond_ctx, uncond_pooled, time_ids,
        story_indices) -> latents: the CFG Euler loop for one (steps, scale,
        shape, id_length, story shapes, CFG form), cached under that key as
        the JAX pipeline caches its jitted loop."""
        key = (num_steps, guidance_scale, shape, id_length, story_shapes, self.batched_cfg)
        if key in self._denoise_cache:
            return self._denoise_cache[key]
        sched = self.scheduler
        sigmas, timesteps = sched.sigmas_and_timesteps(num_steps)
        batched = self.batched_cfg

        @torch.inference_mode()
        def run(latents, ctx, pooled, uncond_ctx, uncond_pooled, time_ids, story_indices):
            if tuple(latents.shape) != tuple(shape):
                raise ValueError(f"latents {tuple(latents.shape)} vs shape {tuple(shape)}")
            B, dev = latents.shape[0], latents.device
            # Consistency groups never mix uncond and cond rows: split CFG
            # makes each call one group, batched CFG stacks two.
            groups = 2 if batched else 1
            story = {path: dict(id_length=id_length, indices=idx, num_groups=groups)
                     for path, idx in story_indices.items()} if story_indices else None
            with span("pipeline.denoise"):
                if batched:
                    ctx2 = torch.cat([uncond_ctx, ctx])
                    cond2 = dict(text_embeds=torch.cat([uncond_pooled, pooled]),
                                 time_ids=torch.cat([time_ids, time_ids]))
                for i in range(num_steps):
                    with span("pipeline.step", i=i):
                        sigma, sigma_next = sigmas[i], sigmas[i + 1]
                        t = int(timesteps[i])
                        lat_in = sched.scale_model_input(latents, sigma)
                        if batched:
                            tt = torch.full((2 * B,), t, dtype=torch.int32, device=dev)
                            eps2 = self.unet(torch.cat([lat_in, lat_in]), tt, ctx2,
                                             added_cond=cond2, story=story)
                            eps_u, eps_c = eps2[:B], eps2[B:]
                        else:
                            tt = torch.full((B,), t, dtype=torch.int32, device=dev)
                            eps_u = self.unet(lat_in, tt, uncond_ctx, story=story,
                                              added_cond=dict(text_embeds=uncond_pooled,
                                                              time_ids=time_ids))
                            eps_c = self.unet(lat_in, tt, ctx, story=story,
                                              added_cond=dict(text_embeds=pooled,
                                                              time_ids=time_ids))
                        eps = eps_u + guidance_scale * (eps_c - eps_u)
                        latents = sched.step(eps, sigma, sigma_next, latents)
            return latents

        self._denoise_cache[key] = run
        return run

    def _story_indices(self, id_length: int, lat_hw: Tuple[int, int], sa_ratio: float,
                       rng: np.random.Generator) -> Dict[str, torch.Tensor]:
        """``story_indices`` of this UNet, on the pipeline's device."""
        return {path: torch.from_numpy(idx).to(self.device)
                for path, idx in story_indices(self.unet.config, id_length, lat_hw,
                                               sa_ratio, rng).items()}

    @torch.inference_mode()
    def _decode_latents(self, latents: torch.Tensor) -> np.ndarray:
        """Images [B, H, W, 3] fp32 in [0, 1], decoded two at a time: the
        full-resolution VAE activations of a whole story batch are large."""
        with span("pipeline.vae_decode"):
            chunks = [(self.vae.decode(latents[i:i + 2]) / 2 + 0.5).clamp(0.0, 1.0)
                      .float().cpu().numpy() for i in range(0, latents.shape[0], 2)]
            return np.concatenate(chunks, axis=0)

    # ------------------------------------------------------------------ call
    def __call__(self, prompt: Sequence[str], negative_prompt: str = "",
                 guidance_scale: float = 5.0, num_inference_steps: int = 50,
                 id_length: int = 0, sa_ratio: float = 0.5,
                 height: Optional[int] = None, width: Optional[int] = None,
                 generator: Optional[torch.Generator] = None, seed: int = 0,
                 ref_images: Optional[Sequence[np.ndarray]] = None, id_encoder=None,
                 trigger_word: str = "img") -> np.ndarray:
        """Generate len(prompt) images [B, H, W, 3] in [0, 1]; with
        id_length > 0 the first id_length rows are identity images and all
        rows share consistent self-attention. With ref_images and a PhotoMaker
        id_encoder, identity also comes from the reference photos through
        trigger-word fusion. The initial noise comes from `generator`, by
        default a generator on the pipeline's device seeded with `seed`."""
        height = height or self.height
        width = width or self.width
        B = len(prompt)
        if ref_images is not None:
            from spider_tpu_torch.models.photomaker import preprocess_id_images

            if id_encoder is None:
                raise ValueError("ref_images need a PhotoMaker id_encoder")
            id_pixels = preprocess_id_images(ref_images, id_encoder.config.image_size)
            ctx, pooled = self.encode_prompt_photomaker(prompt, id_pixels, id_encoder,
                                                        trigger_word)
        else:
            ctx, pooled = self.encode_prompt(prompt)
        un_ctx, un_pooled = self.encode_prompt([negative_prompt] * B)

        factor = 2 ** (len(self.vae.config.block_out_channels) - 1)
        lat_shape = (B, height // factor, width // factor, self.unet.config.in_channels)
        sigmas, _ = self.scheduler.sigmas_and_timesteps(num_inference_steps)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        latents = torch.randn(lat_shape, generator=generator, dtype=torch.float32,
                              device=self.device) * self.scheduler.init_noise_sigma(sigmas)
        time_ids = torch.tensor([[height, width, 0, 0, height, width]], dtype=torch.float32,
                                device=self.device).repeat(B, 1)
        indices = {}
        if id_length > 0:
            indices = self._story_indices(id_length, lat_shape[1:3], sa_ratio,
                                          np.random.default_rng(seed))
        story_key = tuple(sorted((p, int(v.shape[0])) for p, v in indices.items()))
        run = self._denoise_fn(num_inference_steps, guidance_scale, lat_shape, id_length,
                               story_key)
        latents = run(latents, ctx, pooled, un_ctx, un_pooled, time_ids, indices)
        return self._decode_latents(latents)


def init_story_generation(pipe: StoryXLPipeline, **_unused) -> StoryXLPipeline:
    """Signature mirror of StoryDiffusion's Comic_Generation.py:297: the
    models are resident."""
    return pipe


def story_generation(pipe: StoryXLPipeline, general_prompt: str,
                     prompt_array: Sequence[str], style_name: str,
                     id_length: int = 4, sa_ratio: float = 0.5,
                     num_inference_steps: int = 50, seed: int = 0,
                     height: Optional[int] = None, width: Optional[int] = None,
                     ref_images: Optional[Sequence[np.ndarray]] = None, id_encoder=None,
                     trigger_word: str = "img") -> List[np.ndarray]:
    """The reference's two-phase story generation as one consistent joint
    batch: id images seed identity, and every story frame is rendered with
    consistent self-attention against them. With ref_images (and a
    PhotoMaker id_encoder) identity also comes from the reference photos;
    the general_prompt then holds the trigger word after the class word,
    e.g. "a man img". Returns one image [H, W, 3] per story prompt; the id
    images are the first frames."""
    prompts = [f"{general_prompt}, {p}" for p in prompt_array]
    id_prompts = prompts[:id_length]
    if len(id_prompts) < id_length:
        id_prompts = id_prompts + [general_prompt] * (id_length - len(id_prompts))
    all_prompts = id_prompts + prompts[id_length:]
    styled, negative = apply_style(style_name, all_prompts)
    images = pipe(styled, negative_prompt=negative, num_inference_steps=num_inference_steps,
                  id_length=id_length, sa_ratio=sa_ratio, seed=seed, height=height,
                  width=width, ref_images=ref_images, id_encoder=id_encoder,
                  trigger_word=trigger_word)
    return [images[i] for i in range(len(prompts))]


def build_tiny_sdxl(tokenizer=None, *, device, seed: int = 0) -> StoryXLPipeline:
    """Random-init tiny pipeline (CPU tests, offline demos): two tiny text
    encoders (32 and 48 wide, the second projected), a tiny text_time UNet
    and a tiny VAE, at 16 x 16 pixels."""
    import dataclasses

    from spider_tpu_torch.models.clip_text import clip_tiny
    from spider_tpu_torch.models.factory import random_init_
    from spider_tpu_torch.models.tokenizer import TinyTokenizer
    from spider_tpu_torch.models.unet2d import unet_tiny
    from spider_tpu_torch.models.vae import vae_tiny

    tokenizer = tokenizer or TinyTokenizer()
    gen = torch.Generator(device=device).manual_seed(seed)
    t1 = clip_tiny(vocab_size=max(len(tokenizer), 300))
    t2 = dataclasses.replace(t1, hidden_size=48, intermediate_size=96, projection_dim=48)
    enc1 = random_init_(CLIPTextModel(t1, device).eval(), gen)
    enc2 = random_init_(CLIPTextModel(t2, device).eval(), gen)
    ucfg = unet_tiny(cross_attention_dim=t1.hidden_size + t2.hidden_size,
                     addition_embed_type="text_time", projection_dim=48 + 8 * 6)
    unet = random_init_(UNet2DConditionModel(ucfg, device).eval(), gen)
    vae = random_init_(AutoencoderKL(vae_tiny(), device).eval(), gen)
    return StoryXLPipeline(tokenizer, tokenizer, enc1, enc2, unet, vae, height=16, width=16)
