"""Parity of the port's audio path (CLAP text, the class-embedding UNet, the
1-channel VAE, the torch-semantics transposed conv, HiFi-GAN, the AudioLDM
pipeline) with the JAX package, in fp32 on the CPU at tiny widths.

Weights come from the JAX package (its init or numpy draws of its parameter
shapes) through load_jax_params; inputs and latents are made with numpy from
a seed. Tolerances: 1e-5 for one transposed convolution (the same fp32
products summed in another order); 1e-4 for CLAP, the VAE and HiFi-GAN (a
few fp32 matmuls, convolutions and norms); 2e-4 for the tiny UNet (some
dozens of layers); 1e-3 for four CFG denoise steps, where guidance 7.5
amplifies the UNet's differences.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spider_tpu.models import clip_text as jclip
from spider_tpu.models import vocoder as jvoc
from spider_tpu.models.pipelines import ad as jad
from spider_tpu.models.tokenizer import TinyTokenizer as JaxTinyTokenizer
from spider_tpu.ops import convs as jconvs
from spider_tpu_torch.models import clip_text as tclip
from spider_tpu_torch.models import vocoder as tvoc
from spider_tpu_torch.models.convert import load_jax_params
from spider_tpu_torch.models.pipelines import ad as tad
from spider_tpu_torch.models.tokenizer import TinyTokenizer
from spider_tpu_torch.models.unet2d import unet_audioldm
from spider_tpu_torch.models.vae import vae_audioldm
from spider_tpu_torch.ops import convs as tconvs


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _drawn_params(module, *args, scale=0.2, seed=0):
    """numpy N(0, scale) draws of every leaf `module.init` would make, with
    scales around 1 (HiFi-GAN divides by its raw `scale`)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def fill(path, s):
        x = scale * rng.standard_normal(s.shape, dtype=np.float32)
        return x + 1.0 if jax.tree_util.keystr(path).endswith("['scale']") else x

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def pipes():
    """(JAX tiny ad pipeline, port tiny ad pipeline) with the same weights:
    the JAX package's random_params_like init, carried across as numpy."""
    jpipe = jad.build_tiny_ad(tokenizer=JaxTinyTokenizer())
    tpipe = tad.build_tiny_ad(tokenizer=TinyTokenizer(), device="cpu")
    for mod, params in ((tpipe.text_encoder, jpipe.text_params),
                        (tpipe.unet, jpipe.unet_params), (tpipe.vae, jpipe.vae_params),
                        (tpipe.vocoder, jpipe.vocoder_params)):
        load_jax_params(mod, _np_tree(params))
    return jpipe, tpipe


def test_clap_text_with_partial_mask_matches_jax():
    jm = jclip.ClapTextModel(jclip.clap_tiny(300))
    ids = np.random.default_rng(1).integers(3, 300, size=(2, 12)).astype(np.int32)
    mask = np.ones((2, 12), np.int32)
    mask[1, 7:] = 0                       # keys past 7 are masked in row 1
    params = _drawn_params(jm, ids, scale=0.1)
    tm = load_jax_params(tclip.ClapTextModel(tclip.clap_tiny(300)), params)
    want = jm.apply(params, ids, mask)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)


def test_unet_class_embed_matches_jax(pipes):
    jpipe, tpipe = pipes
    x, cls = _randn(2, 2, 6, 4, 4), _randn(3, 2, 16)
    t = np.array([981, 15], np.int32)
    want = jax.jit(jpipe.unet.apply)(jpipe.unet_params, x, t, cls[:, None, :],
                                     dict(class_embeds=cls))
    with torch.no_grad():
        got = tpipe.unet(torch.from_numpy(x), torch.from_numpy(t),
                         torch.from_numpy(cls[:, None, :]),
                         added_cond=dict(class_embeds=torch.from_numpy(cls)))
        with pytest.raises(ValueError, match="class_embeds"):
            tpipe.unet(torch.from_numpy(x), torch.from_numpy(t),
                       torch.from_numpy(cls[:, None, :]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)


def test_one_channel_vae_matches_jax(pipes):
    jpipe, tpipe = pipes
    jm = jpipe.vae
    z, mel = _randn(4, 2, 6, 4, 4), _randn(5, 1, 12, 8, 1)
    apply = jax.jit(jm.apply, static_argnames="method")
    with torch.no_grad():
        np.testing.assert_allclose(
            tpipe.vae.decode(torch.from_numpy(z)).numpy(),
            np.asarray(apply(jpipe.vae_params, z, method=jm.decode)), atol=1e-4, rtol=0)
        np.testing.assert_allclose(
            tpipe.vae.encode(torch.from_numpy(mel)).numpy(),
            np.asarray(apply(jpipe.vae_params, mel, method=jm.encode)), atol=1e-4, rtol=0)


@pytest.mark.parametrize("k,s", [(16, 5), (16, 4), (8, 2), (4, 2)])
def test_conv_transpose1d_matches_jax(k, s):
    # k != s: a flipped or mis-cropped kernel shifts every output sample.
    x = _randn(6, 2, 9, 5)                        # [B, T, C]
    jm = jconvs.ConvTranspose1dTorch(3, k, s)
    params = _drawn_params(jm, x, scale=1.0)
    tm = load_jax_params(tconvs.ConvTranspose1dTorch(5, 3, k, s), params)
    want = np.asarray(jm.apply(params, x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).numpy()
    assert got.shape == want.shape == (2, 8 * s + k - 2 * ((k - s) // 2), 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_hifigan_tiny_matches_jax():
    jm = jvoc.HifiGan(jvoc.hifigan_tiny())
    mel = _randn(7, 2, 10, 8)
    params = _drawn_params(jm, mel, scale=0.3)
    tm = load_jax_params(tvoc.HifiGan(tvoc.hifigan_tiny()), params)
    want = np.asarray(jm.apply(params, mel))
    with torch.no_grad():
        got = tm(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (2, tvoc.output_length(tvoc.hifigan_tiny(), 10))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_vocoder_output_length_matches_jax_at_audioldm_rates():
    # AudioLDM's upsample stages (k=16 s=5 adds one sample) at narrow width.
    jcfg = dataclasses.replace(jvoc.hifigan_audioldm(), model_in_dim=8,
                               upsample_initial_channel=64)
    out = jax.eval_shape(lambda m: jvoc.HifiGan(jcfg).init_with_output(
        jax.random.PRNGKey(0), m)[0], jnp.zeros((1, 10, 8)))
    assert out.shape == (1, tvoc.output_length(tvoc.hifigan_audioldm(), 10))
    # 5 s of audio: 512 mel frames -> 81952 samples (160 x 512 + 32).
    assert tvoc.output_length(tvoc.hifigan_audioldm(), 512) == 81952


def test_audioldm_presets_match_jax():
    from spider_tpu.models import unet2d as ju2
    from spider_tpu.models import vae as jvae

    strip = lambda c, drop: {k: v for k, v in dataclasses.asdict(c).items() if k not in drop}
    assert strip(unet_audioldm(), ("dtype",)) == strip(ju2.unet_audioldm(), ("dtype",))
    assert strip(vae_audioldm(), ("dtype",)) == strip(jvae.vae_audioldm(), ("dtype",))
    assert strip(tvoc.hifigan_audioldm(), ("dtype",)) == strip(jvoc.hifigan_audioldm(),
                                                                 ("dtype",))
    assert strip(tclip.ClapTextConfig(), ("dtype",)) == strip(jclip.ClapTextConfig(),
                                                                ("dtype",))


def test_ad_denoise_and_decode_on_injected_latents_match_jax(pipes):
    jpipe, tpipe = pipes
    prompts = ["galloping hooves on sand"]
    for t, j in zip(tpipe.tokenize(prompts), jpipe.tokenize(prompts)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    cond = np.asarray(jpipe.encode_prompt(prompts))
    uncond = np.asarray(jpipe.encode_prompt([""]))
    np.testing.assert_allclose(tpipe.encode_prompt(prompts).numpy(), cond, atol=1e-4, rtol=0)
    shape = tpipe.latent_shape(1, 0.1)
    assert shape == (1, 6, 4, 4)          # 10 mel frames -> 5 latent, rounded up to 6
    lat = _randn(8, *shape)
    want = jpipe._denoise_fn(4, 7.5, shape)(jpipe.unet_params, lat, cond, uncond,
                                            jax.random.PRNGKey(0))
    got = tpipe._denoise_fn(4, 7.5, shape)(torch.from_numpy(lat), torch.tensor(cond),
                                           torch.tensor(uncond))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=0)
    mel = jpipe.vae.apply(jpipe.vae_params, np.asarray(want), method=jpipe.vae.decode)[..., 0]
    want_wave = np.asarray(jpipe.vocoder.apply(jpipe.vocoder_params, mel))
    wave = tpipe._decode_latents(torch.tensor(np.asarray(want)))
    assert wave.dtype == np.float32 and wave.shape == want_wave.shape == (1, 48)
    np.testing.assert_allclose(wave, want_wave, atol=1e-4, rtol=0)
    out = tpipe(prompt=prompts, num_inference_steps=4, audio_length_in_s=0.1,
                latents=torch.from_numpy(lat))
    np.testing.assert_allclose(out, want_wave, atol=1e-3, rtol=0)
