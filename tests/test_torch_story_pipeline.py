"""Parity of the port's SDXL story pipeline (pipelines/sdxl_story.py) with
the JAX package's, in fp32 on the CPU at tiny widths: prompt encoding
through both text encoders, the CFG Euler denoise loop on injected latents
(batched and split CFG, with and without consistent self-attention), and
story generation end to end. The story entry twin is held to the root
script in tests/test_torch_story_twin.py.

Weights come from the JAX package's tiny SDXL pipeline through
load_jax_params. The JAX pipeline draws its initial latents with jax.random
and the port with a torch.Generator, so the loops are compared on the same
injected latents (ROADMAP conventions, "RNG"). Tolerances: 2e-4 for the
text encoders (fp32 matmuls in another order through two layers); 1e-3 for
the denoise loop, where guidance 5.0 amplifies the UNet's 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spider_tpu.models.pipelines import sdxl_story as jstory
from spider_tpu.models.tokenizer import TinyTokenizer as JaxTinyTokenizer
from spider_tpu_torch.models.convert import load_jax_params
from spider_tpu_torch.models.pipelines import sdxl_story as tstory
from spider_tpu_torch.models.tokenizer import TinyTokenizer

PROMPTS = ["a fox, in a forest", "a fox, by a river", "a fox, at night"]


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def pipes():
    """(JAX tiny SDXL story pipeline, port tiny pipeline with its weights)."""
    jpipe = jstory.build_tiny_sdxl(tokenizer=JaxTinyTokenizer())
    tpipe = tstory.build_tiny_sdxl(tokenizer=TinyTokenizer(), device="cpu")
    load_jax_params(tpipe.text_encoder, _np_tree(jpipe.text_params))
    load_jax_params(tpipe.text_encoder_2, _np_tree(jpipe.text_params_2))
    load_jax_params(tpipe.unet, _np_tree(jpipe.unet_params))
    load_jax_params(tpipe.vae, _np_tree(jpipe.vae_params))
    return jpipe, tpipe


def test_apply_style_and_templates_equal():
    assert tstory.STYLE_TEMPLATES == jstory.STYLE_TEMPLATES
    assert tstory.DEFAULT_STYLE == jstory.DEFAULT_STYLE
    for style in list(jstory.STYLE_TEMPLATES) + ["no such style"]:
        assert (tstory.apply_style(style, ["a cat", "a dog"], "blurry")
                == jstory.apply_style(style, ["a cat", "a dog"], "blurry"))


def test_encode_prompt_matches_jax(pipes):
    jpipe, tpipe = pipes
    jctx, jpooled = jpipe.encode_prompt(PROMPTS + [""])
    ctx, pooled = tpipe.encode_prompt(PROMPTS + [""])
    assert ctx.shape == (4, 77, 80) and pooled.shape == (4, 48)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(jctx), atol=2e-4, rtol=0)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jpooled), atol=2e-4, rtol=0)


@pytest.mark.parametrize("id_length", [0, 2])
@pytest.mark.parametrize("batched", [True, False])
def test_denoise_on_injected_latents_matches_jax(pipes, batched, id_length):
    jpipe, tpipe = pipes
    jpipe.batched_cfg = tpipe.batched_cfg = batched
    B, steps = 3, 2
    shape = (B, 8, 8, 4)
    ctx, pooled = jpipe.encode_prompt(PROMPTS)
    un_ctx, un_pooled = jpipe.encode_prompt([""] * B)
    sigmas, _ = tpipe.scheduler.sigmas_and_timesteps(steps)
    lat = (np.random.default_rng(8).standard_normal(shape, dtype=np.float32)
           * float(tpipe.scheduler.init_noise_sigma(sigmas)))
    time_ids = np.tile(np.asarray([[16, 16, 0, 0, 16, 16]], np.float32), (B, 1))
    idx = {}
    if id_length:
        idx = tstory.story_indices(tpipe.unet.config, id_length, (8, 8), 0.5,
                                   np.random.default_rng(3))
    key = tuple(sorted((p, len(v)) for p, v in idx.items()))
    want = jpipe._denoise_fn(steps, 5.0, shape, id_length, key)(
        jpipe.unet_params, jnp.asarray(lat), ctx, pooled, un_ctx, un_pooled,
        jnp.asarray(time_ids), {p: jnp.asarray(v, jnp.int32) for p, v in idx.items()})
    t = lambda a: torch.from_numpy(np.array(a))
    run = tpipe._denoise_fn(steps, 5.0, shape, id_length, key)
    assert tpipe._denoise_fn(steps, 5.0, shape, id_length, key) is run      # cached by key
    got = run(t(lat), t(ctx), t(pooled), t(un_ctx), t(un_pooled), t(time_ids),
              {p: torch.from_numpy(v) for p, v in idx.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=0)
    img = tpipe._decode_latents(t(want))
    assert img.shape == (B, 16, 16, 3) and img.min() >= 0.0 and img.max() <= 1.0


def test_batched_cfg_resolves_by_device_and_equals_split(pipes):
    _, tpipe = pipes
    assert tstory.build_tiny_sdxl(device="cpu").batched_cfg is True    # batched on every device
    kw = dict(negative_prompt="blurry", num_inference_steps=2, id_length=2, seed=5)
    tpipe.batched_cfg = False
    split = tpipe(PROMPTS, **kw)
    tpipe.batched_cfg = True
    batched = tpipe(PROMPTS, **kw)
    np.testing.assert_allclose(batched, split, atol=1e-5, rtol=0)


def test_story_generation_end_to_end_and_coupling(pipes):
    _, tpipe = pipes
    frames = tstory.story_generation(tpipe, "a fox", ["in a forest", "by a river", "at night"],
                                     "Comic book", id_length=2, num_inference_steps=2, seed=1)
    assert len(frames) == 3
    for f in frames:
        assert f.shape == (16, 16, 3) and f.dtype == np.float32
        assert f.min() >= 0.0 and f.max() <= 1.0
    # fewer prompts than id images: the general prompt fills the id rows
    assert len(tstory.story_generation(tpipe, "a fox", ["in a forest"], "Photographic",
                                       id_length=2, num_inference_steps=2)) == 1
    # consistent self-attention couples the batch: the same prompts with
    # and without the id images differ
    styled, neg = tstory.apply_style("Comic book", ["a fox, in a forest", "a fox, by a river"])
    with_story = tpipe(styled, negative_prompt=neg, num_inference_steps=2, id_length=2, seed=3)
    without = tpipe(styled, negative_prompt=neg, num_inference_steps=2, id_length=0, seed=3)
    assert not np.allclose(with_story, without, atol=1e-6, rtol=0)
