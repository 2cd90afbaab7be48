"""The sharded video denoise and decode (spider_tpu_torch/models/pipelines/vd.py
``_denoise_fn_sharded`` and ``__call__(mesh=)``, models/unet3d.py's frame
split, parallel/collectives.py's frame/pixel all-to-all and halo) against the
port's one-process pipeline and the JAX ``_denoise_fn``.

One 4-rank gloo world (tests/torch_dist_ranks.py::video_world) runs the
tiny ZeroScope pipeline, with the JAX pipeline's weights, over a (cfg, sp)
mesh of cfg 2 x sp 2 and then of cfg 1 x sp 4: 8 frames of 6 x 10 latents
and 6 DDIM steps at guidance 7.5. The tiny UNet3D's second level is 3 x 5 =
15 pixels, which split unevenly over 2 and over 4 ranks; at sp 4 each rank
holds 2 frames, so every frame conv takes a halo from both sides on the
inner ranks.

Tolerances (fp32 on the CPU): the denoised latents within 2e-4 of the
one-process loop and of the JAX ``_denoise_fn``, as the reference holds its
own sharded denoise to its one-device scan (tests/test_sharded_video.py);
the uint8 frames within 1 level of the unsharded call's (the truncating cast
can flip a level where the latents agree within 2e-4).
"""

import jax
import numpy as np
import pytest
import torch

from spider_tpu.models.pipelines import vd as jvd
from spider_tpu.models.tokenizer import TinyTokenizer as JaxTinyTokenizer
from torch_dist_ranks import run_world, tiny_vd

MESHES = [(2, 2), (1, 4)]
STEPS = 6
LATENTS = (1, 8, 6, 10, 4)
PROMPT = "a horse running on a beach"


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jpipe = jvd.build_tiny_vd(tokenizer=JaxTinyTokenizer())
    tree = lambda p: jax.tree_util.tree_map(np.asarray, p)
    weights = dict(text=tree(jpipe.text_params), unet=tree(jpipe.unet_params),
                   vae=tree(jpipe.vae_params))
    lat = np.random.default_rng(70).standard_normal(LATENTS, dtype=np.float32)
    cond = np.array(jpipe.encode_prompt([PROMPT]))
    uncond = np.array(jpipe.encode_prompt([""]))
    res = run_world("video_world", 4, tmp_path_factory.mktemp("video"), weights=weights,
                    latents=lat, cond=cond, uncond=uncond, steps=STEPS, meshes=MESHES,
                    prompt=PROMPT)
    tpipe = tiny_vd(**weights)
    one = tpipe._denoise_fn(STEPS, 7.5, LATENTS)(torch.from_numpy(lat), torch.from_numpy(cond),
                                                 torch.from_numpy(uncond))
    frames = tpipe(prompt=[PROMPT], num_inference_steps=STEPS, height=12, width=20,
                   num_frames=LATENTS[1], latents=torch.from_numpy(lat))
    jax_out = jpipe._denoise_fn(STEPS, 7.5, LATENTS)(jpipe.unet_params, lat, cond, uncond,
                                                     jax.random.PRNGKey(0))
    return dict(res=res, one=one.numpy(), frames=frames, jax=np.asarray(jax_out))


@pytest.mark.parametrize("mesh", range(len(MESHES)), ids=[f"cfg{c}_sp{s}" for c, s in MESHES])
def test_sharded_denoise_equals_the_one_process_and_jax_denoise(setup, mesh):
    np.testing.assert_allclose(setup["one"], setup["jax"], rtol=2e-4, atol=2e-4)
    for rank in setup["res"]:
        got = rank[mesh]["denoised"].numpy()
        assert got.shape == LATENTS
        np.testing.assert_allclose(got, setup["one"], rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got, setup["jax"], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("mesh", range(len(MESHES)), ids=[f"cfg{c}_sp{s}" for c, s in MESHES])
def test_sharded_call_returns_the_whole_video_on_every_rank(setup, mesh):
    want = setup["frames"]
    assert want.dtype == np.uint8 and want.shape == (1, 8, 12, 20, 3)
    for rank in setup["res"]:
        frames = rank[mesh]["frames"]
        assert frames.dtype == np.uint8 and frames.shape == want.shape
        assert np.abs(frames.astype(np.int16) - want.astype(np.int16)).max() <= 1


@pytest.mark.parametrize("mesh", range(len(MESHES)), ids=[f"cfg{c}_sp{s}" for c, s in MESHES])
def test_chip_smoke_computes_the_bytes_a_rank_sends(setup, mesh):
    """chip_smoke.video_sharded_bytes, which prints what one rank of cfg 2 x
    sp 4 would send at ZeroScope's size, against the bytes rank 1 (an inner
    sp rank) sent in one tiny UNet3D call, counted at the torch.distributed
    calls; and the temporal shapes it times for that mesh."""
    import chip_smoke
    from spider_tpu_torch.models.unet3d import unet3d_tiny, unet3d_zeroscope

    n_cfg, n_sp = MESHES[mesh]
    want = chip_smoke.video_sharded_bytes(unet3d_tiny(), *LATENTS[2:4], LATENTS[1], 1, n_cfg,
                                          n_sp, 4)
    sent = dict(setup["res"][1][mesh]["sent"])
    sent.pop("attention_pixels")
    assert sent["all_to_all_bytes"] > 0 and sent["halo_bytes"] > 0
    assert sent == {k: want[k] for k in sent}
    cases = chip_smoke.sharded_tattn_cases(unet3d_zeroscope(), 40, 72, 16, 1, 2, 4)
    assert [(c[3], c[4] // c[5]) for c in cases] == [(720, 40), (180, 80), (45, 160),
                                                    (12, 160)]


@pytest.mark.parametrize("mesh", range(len(MESHES)), ids=[f"cfg{c}_sp{s}" for c, s in MESHES])
def test_temporal_attention_routes_on_the_whole_frames_pixels(setup, mesh):
    """Each temporal attention of the pixel-split layout holds ceil(P / sp)
    pixels, padded, and hands the routing predicate the level's whole P, as
    the reference decides on the global array (so ZeroScope's mid level, 12
    pixels a rank at sp 4, stays on the kernel)."""
    sp = MESHES[mesh][1]
    for rank in setup["res"]:
        calls = rank[mesh]["sent"]["attention_pixels"]
        assert len(calls) == 2 * 8                     # 8 TransformerTemporals, 2 attentions
        assert {(p, whole) for p, whole in calls} == {(-(-60 // sp), 60), (-(-15 // sp), 15)}


@pytest.mark.parametrize("mesh", range(len(MESHES)), ids=[f"cfg{c}_sp{s}" for c, s in MESHES])
def test_frames_that_sp_does_not_divide_raise(setup, mesh):
    sp = MESHES[mesh][1]
    for rank in setup["res"]:
        assert rank[mesh]["error"] == f"{sp + 1} frames do not split over sp = {sp} ranks"
