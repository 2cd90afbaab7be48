"""Parity of the port's PhotoMaker ID encoder (models/photomaker.py) with the
JAX package's, in fp32 on the CPU at tiny widths: the CLIP vision tower, the
FuseModule and the whole PhotoMakerIDEncoder; the host helpers (trigger-word
surgery, id-image preprocessing) equal; the pipeline's PhotoMaker prompt
encoding against the JAX pipeline's; and the ref-image story mode through
story_generation on the tiny SDXL pipeline.

Weights come from the JAX package's init through load_jax_params; inputs are
made with numpy from a seed. Tolerance 2e-4: fp32 matmuls accumulated in
another order through two vision layers and the fuse MLPs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spider_tpu.models import photomaker as jpm
from spider_tpu.models.pipelines import sdxl_story as jstory
from spider_tpu.models.tokenizer import TinyTokenizer as JaxTinyTokenizer
from spider_tpu_torch.models import photomaker as tpm
from spider_tpu_torch.models.convert import load_jax_params
from spider_tpu_torch.models.pipelines import sdxl_story as tstory
from spider_tpu_torch.models.tokenizer import TinyTokenizer


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


@pytest.fixture(scope="module")
def encoders():
    """(JAX module, its params, port encoder with those weights)."""
    jenc, jparams = jpm.build_tiny_photomaker(embed_dim=80)
    tenc = tpm.build_tiny_photomaker(embed_dim=80, device="cpu")
    load_jax_params(tenc, _np_tree(jparams))
    return jenc, jparams, tenc


def test_vision_tower_matches_jax(encoders):
    jenc, jparams, tenc = encoders
    cfg = jenc.config
    pixels = _randn(1, 3, cfg.image_size, cfg.image_size, 3)
    want = jpm.CLIPVisionTower(cfg).apply(
        {"params": jparams["params"]["vision_model"]}, jnp.asarray(pixels))
    with torch.no_grad():
        got = tenc.vision_model(torch.from_numpy(pixels))
    assert got.shape == (3, cfg.hidden_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)


def test_fuse_module_matches_jax(encoders):
    jenc, jparams, tenc = encoders
    prompt, ids = _randn(2, 2, 5, 80), _randn(3, 2, 5, 80)
    want = jpm.FuseModule(80, jnp.float32).apply(
        {"params": jparams["params"]["fuse_module"]}, jnp.asarray(prompt), jnp.asarray(ids))
    with torch.no_grad():
        got = tenc.fuse_module(torch.from_numpy(prompt), torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)


def test_id_encoder_matches_jax_and_fuses_only_marked_positions(encoders):
    jenc, jparams, tenc = encoders
    cfg = jenc.config
    pixels = _randn(4, 2, cfg.image_size, cfg.image_size, 3)
    prompt = _randn(5, 2, 77, 80)
    mask = np.zeros((2, 77), np.int32)
    mask[0, 5], mask[0, 6], mask[1, 9] = 1, 2, 1
    want = np.asarray(jenc.apply(jparams, jnp.asarray(pixels), jnp.asarray(prompt),
                                 jnp.asarray(mask)))
    with torch.no_grad():
        got = tenc(torch.from_numpy(pixels), torch.from_numpy(prompt),
                   torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
    untouched = mask == 0
    np.testing.assert_array_equal(got[untouched], prompt[untouched])
    assert np.abs(got[0, 5] - got[0, 6]).max() > 1e-4      # two different id images


def test_host_helpers_equal():
    jt, tt = JaxTinyTokenizer(), TinyTokenizer()
    prompts = ["a man img walking", "img at the start", "a woman img and a man img", "no trigger"]
    for n_id in (1, 2, 3):
        want = jpm.prompts_with_trigger(jt, prompts, "img", n_id, 32, 2)
        got = tpm.prompts_with_trigger(tt, prompts, "img", n_id, 32, 2)
        for g, w in zip(got, want):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, w)
    rng = np.random.default_rng(0)
    ims = [(rng.random((50, 70, 3)) * 255).astype(np.uint8), rng.random((16, 16, 4), np.float32)]
    got = tpm.preprocess_id_images(ims, 32)
    assert got.dtype == torch.float32 and got.shape == (2, 32, 32, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jpm.preprocess_id_images(ims, 32)))


def test_presets_match_jax():
    for name in ("photomaker_v1", "photomaker_tiny"):
        j, t = getattr(jpm, name)(), getattr(tpm, name)()
        for f in ("hidden_size", "intermediate_size", "num_hidden_layers",
                  "num_attention_heads", "patch_size", "image_size", "projection_dim",
                  "projection_dim_2", "embed_dim"):
            assert getattr(t, f) == getattr(j, f), (name, f)


def test_encode_prompt_photomaker_matches_jax(encoders):
    jenc, jparams, tenc = encoders
    jpipe = jstory.build_tiny_sdxl(tokenizer=JaxTinyTokenizer())
    tpipe = tstory.build_tiny_sdxl(tokenizer=TinyTokenizer(), device="cpu")
    load_jax_params(tpipe.text_encoder, _np_tree(jpipe.text_params))
    load_jax_params(tpipe.text_encoder_2, _np_tree(jpipe.text_params_2))
    refs = [(np.random.default_rng(i).random((24, 24, 3)) * 255).astype(np.uint8)
            for i in (1, 2)]
    pixels = jpm.preprocess_id_images(refs, jenc.config.image_size)
    prompts = ["a man img, at the beach", "a man img, in the forest"]
    jctx, jpooled = jpipe.encode_prompt_photomaker(prompts, pixels, jenc, jparams)
    ctx, pooled = tpipe.encode_prompt_photomaker(
        prompts, tpm.preprocess_id_images(refs, tenc.config.image_size), tenc)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(jctx), atol=2e-4, rtol=0)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jpooled), atol=2e-4, rtol=0)


def test_ref_image_story_mode(encoders):
    tenc = encoders[2]
    pipe = tstory.build_tiny_sdxl(device="cpu")
    ref = (np.random.default_rng(1).random((24, 24, 3)) * 255).astype(np.uint8)
    kw = dict(id_length=2, num_inference_steps=2)
    imgs = tstory.story_generation(pipe, "a man img", ["at the beach", "in the forest"],
                                   "Japanese Anime", ref_images=[ref], id_encoder=tenc, **kw)
    assert len(imgs) == 2 and imgs[0].shape == (16, 16, 3)
    assert all(0.0 <= im.min() and im.max() <= 1.0 for im in imgs)
    base = tstory.story_generation(pipe, "a man img", ["at the beach", "in the forest"],
                                   "Japanese Anime", **kw)
    assert not np.allclose(imgs[0], base[0], atol=1e-6, rtol=0)   # identity conditioning
    with pytest.raises(ValueError, match="id_encoder"):
        pipe(["a man img"], ref_images=[ref], num_inference_steps=1)
