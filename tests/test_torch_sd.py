"""Parity of the port's image path (CLIP text, UNet, VAE, DDIM, the SD
denoise loop) with the JAX package, in fp32 on the CPU at tiny widths.

Weights come from the JAX package's init through load_jax_params; inputs
and the initial latents are made with numpy from a seed, because
jax.random and torch.Generator draw different numbers. Tolerances: 1e-5 for
the scheduler and embeddings (the same fp32 formulas); 2e-4 for the CLIP
text encoder, UNet and VAE (fp32 convolutions and matmuls accumulated in
another order through a few dozen layers); 1e-3 for four CFG denoise steps,
where guidance 7.5 amplifies the UNet's differences.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spider_tpu.models import schedulers as jsched
from spider_tpu.models.pipelines import sd as jsd
from spider_tpu.models.tokenizer import TinyTokenizer as JaxTinyTokenizer
from spider_tpu_torch.models import schedulers as tsched
from spider_tpu_torch.models.convert import load_jax_params
from spider_tpu_torch.models.pipelines import sd as tsd
from spider_tpu_torch.models.tokenizer import TinyTokenizer


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


@pytest.fixture(scope="module")
def pipes():
    """(JAX tiny SD pipeline, port tiny SD pipeline) with the same weights:
    the JAX package's random_params_like init, carried across as numpy."""
    jpipe = jsd.build_tiny_sd(tokenizer=JaxTinyTokenizer())
    tpipe = tsd.build_tiny_sd(tokenizer=TinyTokenizer(), device="cpu")
    load_jax_params(tpipe.text_encoder, _np_tree(jpipe.text_params))
    load_jax_params(tpipe.unet, _np_tree(jpipe.unet_params))
    load_jax_params(tpipe.vae, _np_tree(jpipe.vae_params))
    return jpipe, tpipe


def test_clip_text_matches_jax(pipes):
    jpipe, tpipe = pipes
    eos = jpipe.text_encoder.config.eos_token_id
    ids = np.random.default_rng(1).integers(3, 300, size=(2, 77)).astype(np.int32)
    ids[0, 20:] = eos
    ids[1, 50:] = eos
    want = jax.jit(jpipe.text_encoder.apply)(jpipe.text_params, jnp.asarray(ids))
    with torch.no_grad():
        got = tpipe.text_encoder(torch.from_numpy(ids).long())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4, rtol=0)


def test_unet_matches_jax(pipes):
    jpipe, tpipe = pipes
    x, ctx = _randn(1, 2, 8, 8, 4), _randn(2, 2, 7, 32)
    t = np.array([981, 15], np.int32)
    want = jax.jit(jpipe.unet.apply)(jpipe.unet_params, x, t, ctx)
    with torch.no_grad():
        got = tpipe.unet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    assert got.shape == (2, 8, 8, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)


def test_vae_decode_and_encode_match_jax(pipes):
    jpipe, tpipe = pipes
    jm = jpipe.vae
    z, img = _randn(3, 2, 8, 8, 4), _randn(4, 1, 16, 16, 3)
    with torch.no_grad():
        got_img = tpipe.vae.decode(torch.from_numpy(z))
        got_z = tpipe.vae.encode(torch.from_numpy(img))
    apply = jax.jit(jm.apply, static_argnames="method")
    np.testing.assert_allclose(
        got_img.numpy(), np.asarray(apply(jpipe.vae_params, z, method=jm.decode)),
        atol=2e-4, rtol=0)
    np.testing.assert_allclose(
        got_z.numpy(), np.asarray(apply(jpipe.vae_params, img, method=jm.encode)),
        atol=2e-4, rtol=0)


@pytest.mark.parametrize("schedule", ["scaled_linear", "linear", "squaredcos_cap_v2"])
def test_betas_and_timestep_embedding_match_jax(schedule):
    # squaredcos betas are 1 - a ratio of fp32 cosines: 1 ulp of that ratio
    # is ~6e-8, so they agree to an absolute 1e-6.
    np.testing.assert_allclose(tsched.make_betas(schedule=schedule).numpy(),
                               np.asarray(jsched.make_betas(schedule=schedule)),
                               atol=1e-6, rtol=0)
    t = np.array([981, 1, 500], np.int32)
    for dim in (16, 15):
        np.testing.assert_allclose(
            tsched.timestep_embedding(torch.from_numpy(t), dim).numpy(),
            np.asarray(jsched.timestep_embedding(jnp.asarray(t), dim)), atol=1e-5, rtol=0)


@pytest.mark.parametrize("eta", [0.0, 0.5])
@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
def test_ddim_step_matches_jax(eta, prediction_type):
    js = jsched.DDIMScheduler(prediction_type=prediction_type)
    ts = tsched.DDIMScheduler(prediction_type=prediction_type)
    assert ts.timesteps(40) == [int(x) for x in np.asarray(js.timesteps(40))]
    eps, x, noise = _randn(5, 1, 4, 4, 4), _randn(6, 1, 4, 4, 4), _randn(7, 1, 4, 4, 4)
    for t in (976, 501, 1):        # the last step steps past t = 0
        want = js.step(eps, t, x, 40, eta=eta, noise=noise)
        got = ts.step(torch.from_numpy(eps), t, torch.from_numpy(x), 40, eta=eta,
                      noise=torch.from_numpy(noise))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_sd_denoise_on_injected_latents_matches_jax(pipes):
    jpipe, tpipe = pipes
    prompts = ["a running horse on a beach"]
    np.testing.assert_array_equal(tpipe.tokenize(prompts).numpy(),
                                  np.asarray(jpipe.tokenize(prompts)))
    cond = np.asarray(jpipe.encode_prompt(prompts))
    uncond = np.asarray(jpipe.encode_prompt([""]))
    np.testing.assert_allclose(tpipe.encode_prompt(prompts).numpy(), cond, atol=2e-4, rtol=0)
    lat = _randn(8, 1, 8, 8, 4)
    want = jpipe._denoise_fn(4, 7.5, lat.shape)(jpipe.unet_params, lat, cond, uncond,
                                                jax.random.PRNGKey(0))
    got = tpipe._denoise_fn(4, 7.5, lat.shape)(torch.from_numpy(lat), torch.tensor(cond),
                                               torch.tensor(uncond))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=0)
    img = tpipe._decode_latents(torch.tensor(np.asarray(want)))
    np.testing.assert_allclose(img, jpipe._decode_latents(want), atol=2e-4, rtol=0)


def test_sd_call_with_injected_latents_matches_jax_pieces(pipes):
    # The port's __call__ with `latents` runs the same steps as the JAX
    # pipeline's encode -> denoise -> decode on those latents.
    jpipe, tpipe = pipes
    lat = _randn(9, 1, 8, 8, 4)
    cond = jpipe.encode_prompt(["a cat"])
    uncond = jpipe.encode_prompt([""])
    want = jpipe._decode_latents(jpipe._denoise_fn(4, 7.5, lat.shape)(
        jpipe.unet_params, lat, cond, uncond, jax.random.PRNGKey(0)))
    got = tpipe(prompt=["a cat"], num_inference_steps=4, latents=torch.from_numpy(lat))
    assert got.shape == (1, 16, 16, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
