"""Parity of the port's ImageBind encoder with the flax module.

Weights come from the flax init (a fixed key; the cls token, which flax
starts at zero, is made non-zero) through load_jax_params, which carries the
3-D patch convolution's [kd,kh,kw,in,out] kernel onto nn.Conv3d; inputs are
made with numpy from a seed. fp32 on the CPU at imagebind_tiny width.
Tolerance 1e-4: the same fp32 arithmetic in another summation order through
two ViT blocks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spider_tpu.models import imagebind as jI
from spider_tpu_torch.models import imagebind as tI
from spider_tpu_torch.models.convert import load_jax_params

ATOL = 1e-4


def _pair():
    jcfg = jI.imagebind_tiny()
    jm = jI.ImageBindEncoder(jcfg)
    rng = np.random.default_rng(0)
    params = jm.init(jax.random.PRNGKey(0), {
        "vision": jnp.zeros((1, 3, 2, jcfg.image_size, jcfg.image_size)),
        "audio": jnp.zeros((1, 1, jcfg.audio_mel_bins, jcfg.audio_target_len))})
    params = jax.tree_util.tree_map(np.asarray, params)
    for trunk in ("vision_trunk", "audio_trunk"):
        cls = params["params"][trunk]["cls_token"]
        params["params"][trunk]["cls_token"] = 0.1 * rng.standard_normal(cls.shape).astype(
            np.float32)
    tm = load_jax_params(tI.ImageBindEncoder(tI.imagebind_tiny()), params).eval()
    return jm, params, tm


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 3, 28, 28), (2, 3, 2, 28, 28), (2, 3, 3, 2, 28, 28)],
                         ids=["image", "frames", "clips"])
def test_vision_matches_flax(shape):
    jm, params, tm = _pair()
    x = _x(shape, seed=len(shape))
    want = jm.apply(params, {"vision": jnp.asarray(x)})["vision"]
    with torch.no_grad():
        got = tm({"vision": torch.from_numpy(x)})["vision"]
    assert got.shape == (2, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("shape", [(2, 1, 16, 20), (2, 3, 1, 16, 20)], ids=["clip", "clips"])
def test_audio_matches_flax(shape):
    jm, params, tm = _pair()
    x = _x(shape, seed=10 + len(shape))
    want = jm.apply(params, {"audio": jnp.asarray(x)})["audio"]
    with torch.no_grad():
        got = tm({"audio": torch.from_numpy(x)})["audio"]
    assert got.shape == (2, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_both_modalities_in_one_call_and_full_size_token_grids():
    jm, params, tm = _pair()
    v, a = _x((1, 3, 28, 28), 20), _x((1, 1, 16, 20), 21)
    want = jm.apply(params, {"vision": jnp.asarray(v), "audio": jnp.asarray(a)})
    with torch.no_grad():
        got = tm({"vision": torch.from_numpy(v), "audio": torch.from_numpy(a)})
    for k in ("vision", "audio"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL, rtol=0)
    # imagebind_huge's position tables, from the shapes flax would create
    # (meta tensors: nothing is allocated)
    huge = tI.ImageBindEncoder(tI.imagebind_huge(), device="meta")
    shapes = jax.eval_shape(
        jI.ImageBindEncoder(jI.imagebind_huge()).init, jax.random.PRNGKey(0),
        {"vision": jnp.zeros((1, 3, 2, 224, 224)), "audio": jnp.zeros((1, 1, 128, 204))})
    for trunk in ("vision_trunk", "audio_trunk"):
        assert (tuple(getattr(huge, trunk).pos_embed.shape)
                == shapes["params"][trunk]["pos_embed"].shape)
