"""The port's SDXL story path against the benchmark's plain fp32 reference
(``benchmark/reference/sdxl.py``) at the tiny size on the CPU, on seeded
random weights (``benchmark/weights.py``): the conditioning and the pooled
vector, one UNet call with the story bank in each of the port's bank forms,
one Euler step and the decode. The reference writes consistent
self-attention as one softmax over the concatenated keys, so the port's
split form (two attentions merged through their logsumexps) is checked, not
copied; and the ablation without the bank must miss the reference with it.
"""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import weights
from benchmark.check import rel_l2
from benchmark.loops.story import MODULES, bank_indices, latent_hw
from benchmark.reference import build, sdxl

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark",
                    "tests", "data")
# Both sides compute in fp32 on the CPU, the same equations in another order
# (the port's logsumexp merge, its GEGLU split, its fused SiLU): they part by
# 1e-7 to 1e-6 relative. A term left out or another drawn (the bank, its
# indices) moves a whole UNet call by 7e-4 or more, so 1e-4 tells them apart.
TOL = 1e-4


def _json(name):
    with open(os.path.join(DATA, name + ".json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def pair():
    """(the port's tiny SDXL pipeline, the reference's four models, the
    configuration, the point) on the same weights."""
    from spider_tpu_torch.models.pipelines.sdxl_story import build_tiny_sdxl

    pipe = build_tiny_sdxl(device=torch.device("cpu"))
    mods = {name: getattr(pipe, name) for name in MODULES}
    values = weights.fill(weights.module_specs(mods), 5, "cpu", torch.float32)
    weights.load_into(mods, values)
    cfg = _json("tiny_sdxl")
    ref = sdxl.models(cfg, "cpu")
    for module, prefix in zip(ref, MODULES):
        build.load(module, prefix, values)
    return pipe, ref, cfg, _json("tiny_sdxl.story")["point"]


PROMPTS = ["", "a red fox", "anime artwork of a lighthouse on a cliff under a stormy sky, anime "
           "style, vibrant colors, clean line art, studio anime, key visual, highly detailed"]


def test_conditioning_and_pooled_vector(pair):
    pipe, (text, text_2, _, _), cfg, _ = pair
    ids = [torch.tensor([sdxl.token_ids(p, 77, c["eos_token_id"]) for p in PROMPTS])
           for c in (cfg["text_encoder_as_run"], cfg["text_encoder_2_as_run"])]
    for tok, want in zip((pipe.tokenizer, pipe.tokenizer_2), ids):
        assert torch.equal(pipe._tokenize(tok, PROMPTS, 77, 2), want)
    ctx, pooled = pipe.encode_prompt(PROMPTS)
    with torch.no_grad():
        (h1, none), (h2, want_pooled) = text(ids[0]), text_2(ids[1])
    assert none is None and ctx.shape == (3, 77, 80) and pooled.shape == (3, 48)
    assert rel_l2(ctx, torch.cat([h1, h2], dim=-1)) < TOL
    assert rel_l2(pooled, want_pooled) < TOL


def _unet_inputs(cfg, point, rows, id_length, groups, seed=9):
    """The UNet's inputs for `groups` groups of `rows` rows and the bank
    indices of `id_length` id rows."""
    B = rows * groups
    g = torch.Generator().manual_seed(seed)
    h, w = latent_hw(cfg, point)
    x = torch.randn(B, h, w, 4, generator=g)
    ctx = torch.randn(B, 77, cfg["unet_as_run"]["cross_attention_dim"], generator=g)
    embeds = torch.randn(B, cfg["text_encoder_2_as_run"]["projection_dim"], generator=g)
    time_ids = torch.tensor([[16.0, 16.0, 0.0, 0.0, 16.0, 16.0]]).repeat(B, 1)
    t = torch.full((B,), 701)
    idx = {path: torch.from_numpy(v)
           for path, v in bank_indices(cfg, dict(point, id_length=id_length), seed).items()}
    return x, t, ctx, embeds, time_ids, idx


def _port_eps(pipe, inputs, id_length, groups, impl):
    from spider_tpu_torch.models.unet2d import story_bank_config

    x, t, ctx, embeds, time_ids, idx = inputs
    story = {path: dict(id_length=id_length, indices=v, num_groups=groups)
             for path, v in idx.items()}
    with story_bank_config(impl), torch.no_grad():
        return pipe.unet(x, t, ctx, added_cond=dict(text_embeds=embeds, time_ids=time_ids),
                         story=story)


SHAPES = [(5, 4, 2), (3, 2, 1)]           # (rows a group, id_length, groups)


@pytest.mark.parametrize("impl", ["split", "self_only"])
@pytest.mark.parametrize("rows,id_length,groups", SHAPES)
def test_one_unet_call_in_each_bank_form(pair, impl, rows, id_length, groups):
    """"split" against the reference with the bank, "self_only" against the
    reference without it."""
    pipe, (_, _, unet, _), cfg, point = pair
    inputs = _unet_inputs(cfg, point, rows, id_length, groups)
    x, t, ctx, embeds, time_ids, idx = inputs
    story = None if impl == "self_only" else sdxl.story_of(idx, id_length, groups)
    with torch.no_grad():
        want = unet(x, t, ctx, embeds, time_ids, story)
    assert rel_l2(_port_eps(pipe, inputs, id_length, groups, impl), want) < TOL


@pytest.mark.parametrize("rows,id_length,groups", SHAPES)
def test_the_form_without_the_bank_misses_the_reference_with_it(pair, rows, id_length, groups):
    pipe, (_, _, unet, _), cfg, point = pair
    inputs = _unet_inputs(cfg, point, rows, id_length, groups)
    x, t, ctx, embeds, time_ids, idx = inputs
    with torch.no_grad():
        want = unet(x, t, ctx, embeds, time_ids, sdxl.story_of(idx, id_length, groups))
    assert rel_l2(_port_eps(pipe, inputs, id_length, groups, "split"), want) < TOL
    # the bank moves the whole call by 7e-4 to 9e-4 here: random weights
    # spread attention nearly evenly over the keys
    assert rel_l2(_port_eps(pipe, inputs, id_length, groups, "self_only"), want) > TOL


@pytest.mark.parametrize("config,hw", [("tiny", (8, 8)), ("sdxl", (96, 96))])
def test_the_bank_indices_are_the_ports(config, hw):
    """The benchmark's independent draw gives the port's indices, at the
    tiny size and at the story cell's (768 px: 1152 and 4608 a block)."""
    from spider_tpu_torch.models.pipelines.sdxl_story import story_indices
    from spider_tpu_torch.models.unet2d import unet_sdxl, unet_tiny

    if config == "tiny":
        cfg, ucfg = _json("tiny_sdxl"), unet_tiny(addition_embed_type="text_time")
    else:
        with open(os.path.join(os.path.dirname(DATA), "..", "configs", "sdxl_story.json")) as f:
            cfg = json.load(f)
        ucfg = unet_sdxl()
    point = dict(id_length=4, sa_ratio=0.5, height=hw[0] * 2 ** (len(
        cfg["vae_as_run"]["block_out_channels"]) - 1), width=hw[1] * 2 ** (len(
            cfg["vae_as_run"]["block_out_channels"]) - 1))
    for seed in (0, 2 ** 40 + 3):
        mine = bank_indices(cfg, point, seed)
        port = story_indices(ucfg, 4, hw, 0.5, np.random.default_rng(seed))
        assert mine.keys() == port.keys() and mine
        for path in mine:
            assert np.array_equal(mine[path], port[path]), path
    if config == "sdxl":
        assert {len(v) for v in mine.values()} == {1152, 4608}


def test_one_euler_step(pair):
    pipe, _, cfg, point = pair
    sched = pipe.scheduler
    steps = 50
    sigmas, timesteps = sched.sigmas_and_timesteps(steps)
    want_sigmas, want_ts = sdxl.euler_schedule(cfg["scheduler"], steps)
    assert timesteps.tolist() == want_ts
    # the port's schedule is fp32 (a cumulative product over 1000 betas), the
    # reference's fp64: they part by up to 2.4e-6 relative, at the small sigmas
    np.testing.assert_allclose(sigmas.double().numpy(), want_sigmas, rtol=1e-5)
    assert float(sched.init_noise_sigma(sigmas)) == pytest.approx(
        sdxl.init_noise_sigma(want_sigmas), rel=1e-5)
    g = torch.Generator().manual_seed(4)
    lat = torch.randn(5, 8, 8, 4, generator=g) * 3
    eps_u, eps_c = torch.randn(2, 5, 8, 8, 4, generator=g)
    k = 17
    got = sched.step(eps_u + point["guidance_scale"] * (eps_c - eps_u), sigmas[k], sigmas[k + 1],
                     lat)
    want = sdxl.guided_euler_step(lat, eps_u, eps_c, point["guidance_scale"], want_sigmas[k],
                                  want_sigmas[k + 1])
    assert rel_l2(got - lat, want - lat) < TOL
    assert rel_l2(sched.scale_model_input(lat, sigmas[k]), sdxl.scale_input(lat, want_sigmas[k])) \
        < TOL


def test_the_decode(pair):
    pipe, (_, _, _, vae), cfg, point = pair
    z = torch.randn(3, *latent_hw(cfg, point), 4, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        assert rel_l2(pipe.vae.decode(z), vae(z)) < TOL
