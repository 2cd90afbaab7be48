"""Parity of the port's Qwen2.5-Omni token2wav with the JAX package: the
ECAPA speaker encoder, the DiT and its RK4 sampler, the anti-aliased
resampling, BigVGAN, and the DiT and BigVGAN rule sets.

Weights: the JAX package's ``build_tiny_token2wav`` (fixed key) with
N(0, 0.1) noise added to every leaf, carried to the port through
``load_jax_params``; inputs are made with numpy from seeds. fp32 on the CPU.
ECAPA, the DiT's velocity and BigVGAN's waveform are held to 1e-4 absolute;
``dit_sample``, given the reference's initial noise (drawn here as the
reference draws it), to 1e-4 + 1e-4 |mel|; filters and converted tensors are
equal exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spider_tpu.models import convert as JC
from spider_tpu.models import omni_token2wav as jw
from spider_tpu_torch.models import convert as TC
from spider_tpu_torch.models import omni_token2wav as tw
from spider_tpu_torch.models.convert import load_jax_params
from test_torch_grounding import _assert_same_state, _manifest, _np_tree, perturbed

ATOL = 1e-4


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _pair():
    j = jw.build_tiny_token2wav()
    dparams, vparams = perturbed(j.dit_params, 6, scale=0.1), perturbed(j.vocoder_params, 7,
                                                                          scale=0.1)
    dit = load_jax_params(tw.DiTModel(tw.dit_tiny()), dparams).eval()
    voc = load_jax_params(tw.BigVGAN(tw.bigvgan_tiny()), vparams).eval()
    return j, dparams, vparams, dit, voc


def test_ecapa_matches_jax():
    j, dparams, _, dit, _ = _pair()
    ref = _x((2, 11, j.dit.config.mel_dim), 1)
    want = jax.jit(jw.ECAPAEncoder(j.dit.config).apply)(
        {"params": dparams["params"]["spk_encoder"]}, jnp.asarray(ref))
    with torch.no_grad():
        got = dit.spk_encoder(torch.from_numpy(ref))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["cfg", "drop_audio_cond", "plain"])
def test_dit_velocity_matches_jax(mode):
    j, dparams, _, dit, _ = _pair()
    cfg = j.dit.config
    x, spk = _x((1, 18, cfg.mel_dim), 2), _x((1, 18, cfg.enc_emb_dim), 3)
    ref = _x((1, 10, cfg.mel_dim), 4)
    code = np.random.default_rng(5).integers(0, cfg.num_embeds, (1, 9)).astype(np.int32)
    kw = dict(apply_cfg=mode == "cfg", drop_audio_cond=mode == "drop_audio_cond")
    # one compile of the whole call, not one for each of its ops
    want = jax.jit(functools.partial(j.dit.apply, **kw))(
        dparams, jnp.asarray(x), jnp.asarray(spk), jnp.asarray(ref), jnp.asarray(code), 0.37)
    with torch.no_grad():
        got = dit(torch.from_numpy(x), torch.from_numpy(spk), torch.from_numpy(ref),
                  torch.from_numpy(code).long(), 0.37, **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("steps", [4])
def test_dit_sample_with_the_reference_noise_matches_jax(steps):
    j, dparams, _, dit, _ = _pair()
    cfg = j.dit.config
    rng = np.random.default_rng(8)
    code = rng.integers(0, cfg.num_embeds, (1, 9)).astype(np.int32)
    cond, ref = _x((1, cfg.enc_emb_dim), 9), _x((1, 11, cfg.mel_dim), 10)
    key = jax.random.PRNGKey(steps)
    want = np.asarray(jw.dit_sample(j.dit, dparams, jnp.asarray(code), jnp.asarray(cond),
                                    jnp.asarray(ref), key, num_steps=steps))
    # the reference's draw (omni_token2wav.py:397), injected
    noise = np.array(jax.random.normal(key, (1, code.shape[1] * cfg.repeats, cfg.mel_dim),
                                       jnp.float32))
    got = tw.dit_sample(dit, torch.from_numpy(code).long(), torch.from_numpy(cond),
                        torch.from_numpy(ref), num_steps=steps, noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=ATOL)
    lin = jnp.linspace(0.0, 1.0, steps)
    np.testing.assert_array_equal(tw.time_grid(steps, None).numpy(), np.asarray(lin))
    np.testing.assert_allclose(tw.time_grid(steps).numpy(),
                               np.asarray(lin - (jnp.cos(jnp.pi / 2 * lin) - 1 + lin)),
                               atol=1e-7, rtol=0)


@pytest.mark.parametrize("frames", [13, 6])
def test_resampling_and_bigvgan_match_jax(frames):
    j, _, vparams, _, voc = _pair()
    for K, cutoff in ((12, 0.25), (11, 0.2)):
        np.testing.assert_array_equal(tw._kaiser_sinc_filter(cutoff, 0.3, K),
                                      jw._kaiser_sinc_filter(cutoff, 0.3, K))
    x = _x((2, frames, 5), frames)
    up = tw._upsample1d(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    np.testing.assert_allclose(up.numpy(), np.asarray(jw._upsample1d(jnp.asarray(x))),
                               atol=1e-6, rtol=0)
    down = tw._downsample1d(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    np.testing.assert_allclose(down.numpy(), np.asarray(jw._downsample1d(jnp.asarray(x))),
                               atol=1e-6, rtol=0)
    mel = _x((1, frames, 8), frames + 1)
    want = np.asarray(jax.jit(j.vocoder.apply)(vparams, jnp.asarray(mel)))
    with torch.no_grad():
        got = voc(torch.from_numpy(mel))
    assert got.shape == want.shape == (1, frames * 4)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


# ---- rule sets -----------------------------------------------------------------------

def _manifest_cfgs(name):
    import dataclasses

    if name == "omni_dit":
        j = dataclasses.replace(jw.dit_tiny(), num_hidden_layers=22, look_ahead_layers=(10,),
                                look_backward_layers=(0, 20))
        return j, dataclasses.replace(tw.dit_tiny(), num_hidden_layers=22,
                                      look_ahead_layers=(10,), look_backward_layers=(0, 20))
    j = jw.BigVGANConfig(mel_dim=8, upsample_initial_channel=64)
    return j, tw.BigVGANConfig(mel_dim=8, upsample_initial_channel=64)


_RULES = {"omni_dit": (TC.omni_dit_rules, JC.convert_omni_dit, tw.DiTModel,
                       "token2wav.code2wav_dit_model."),
          "omni_bigvgan": (TC.omni_bigvgan_rules, JC.convert_omni_bigvgan, tw.BigVGAN,
                           "token2wav.code2wav_bigvgan_model.")}


@functools.lru_cache(maxsize=None)
def _sd(name, prefixed):
    """A state dict with the manifest's key list (the DiT's unread rotary
    table among them), from a port module filled with seeded values."""
    rules_fn, _, make, prefix = _RULES[name]
    _, tc = _manifest_cfgs(name)
    module = make(tc)
    gen = torch.Generator().manual_seed(17)
    with torch.no_grad():
        for t in module.state_dict().values():
            t.copy_(torch.randn(t.shape, generator=gen))
    keys = _manifest(name)
    sd = TC.export_state_dict(rules_fn(keys, tc), module.state_dict())
    if name == "omni_dit":
        sd["rotary_embed.inv_freq"] = torch.ones(tc.head_dim // 2)
    assert set(sd) == set(keys)
    if prefixed:
        sd = {prefix + k: v for k, v in sd.items()}
        sd["talker.codec_head.weight"] = torch.zeros(2, 2)
    return {k: v.numpy() for k, v in sd.items()}


@pytest.mark.parametrize("prefixed", [False, True], ids=["bare", "token2wav"])
@pytest.mark.parametrize("name", ["omni_dit", "omni_bigvgan"])
def test_token2wav_rules_match_the_reference_converter_bit_for_bit(name, prefixed):
    rules_fn, ref_fn, make, _ = _RULES[name]
    jc, tc = _manifest_cfgs(name)
    sd = _sd(name, prefixed)
    want = load_jax_params(make(tc), _np_tree(ref_fn(sd, jc)))
    got = make(tc)
    rules = rules_fn(sd, tc)
    got.load_state_dict(TC.convert_state_dict(rules, sd), strict=True)
    _assert_same_state(got, want)
    read = {k for r in rules for k in r.keys}
    assert not any(k.endswith("rotary_embed.inv_freq") or k.startswith("talker.") for k in read)
    assert len(read) == len(sd) - (name == "omni_dit") - prefixed


@pytest.mark.parametrize("name", ["omni_dit", "omni_bigvgan"])
def test_full_token2wav_reads_exactly_the_manifest(name):
    rules_fn, _, make, _ = _RULES[name]
    keys = set(_manifest(name))
    module = make(tw.dit_full() if name == "omni_dit" else tw.bigvgan_full(), "meta")
    rules = rules_fn(keys, module.config)
    read = [k for r in rules for k in r.keys]
    filled = [n for r in rules for n in r.names]
    assert len(read) == len(set(read)) and len(filled) == len(set(filled))
    assert set(read) == keys - {"rotary_embed.inv_freq"}
    assert set(filled) == set(module.state_dict())
