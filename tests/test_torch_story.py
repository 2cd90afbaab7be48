"""Parity of the port's SDXL story path at the module level with the JAX
package, in fp32 on the CPU at tiny widths: the Euler scheduler,
``attention_with_lse``, the tiny text_time UNet with and without consistent
self-attention (every bank form, one and two consistency groups, extra keys
on a down block), and the sampled story indices, bit-equal at the tiny and
at the full SDXL configuration. The pipeline (prompt encoding, the CFG
denoise loop, story generation) is in tests/test_torch_story_pipeline.py.

Weights come from the JAX package's tiny SDXL pipeline through
load_jax_params; inputs are made with numpy from a seed. On the CPU the
reference's ``_attention_lse`` takes its einsum form, as the port's
``attention_with_lse`` does.
Tolerances: the timesteps are equal; the sigmas agree to a relative 3e-6
(both are the same fp32 formulas, but XLA takes the cumulative product of
the 1000 alphas as a blocked scan and torch in sequence: a few ulps apart
where 1 - alpha_bar cancels, while the JAX schedule itself is up to 1.3e-5
off the float64 one), an Euler step to 1e-5, 2e-4 for attention and
the UNet (fp32 convolutions and matmuls accumulated in another order).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spider_tpu.models import schedulers as jsched
from spider_tpu.models import unet2d as junet
from spider_tpu.models.pipelines import sdxl_story as jstory
from spider_tpu.models.tokenizer import TinyTokenizer as JaxTinyTokenizer
from spider_tpu_torch.models import schedulers as tsched
from spider_tpu_torch.models import unet2d as tunet
from spider_tpu_torch.models.convert import load_jax_params
from spider_tpu_torch.models.pipelines import sdxl_story as tstory
from spider_tpu_torch.ops import attention as tattn
from spider_tpu_torch.models.tokenizer import TinyTokenizer


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


@pytest.fixture(scope="module")
def unets():
    """(JAX tiny SDXL pipeline, port tiny text_time UNet with its weights)."""
    jpipe = jstory.build_tiny_sdxl(tokenizer=JaxTinyTokenizer())
    tpipe = tstory.build_tiny_sdxl(tokenizer=TinyTokenizer(), device="cpu")
    load_jax_params(tpipe.unet, _np_tree(jpipe.unet_params))
    return jpipe, tpipe.unet


# ---- Euler -----------------------------------------------------------------

@pytest.mark.parametrize("spacing", ["leading", "linspace"])
@pytest.mark.parametrize("steps", [4, 30, 50])
def test_euler_sigmas_and_timesteps_match_jax(steps, spacing):
    js = jsched.EulerDiscreteScheduler(timestep_spacing=spacing)
    ts = tsched.EulerDiscreteScheduler(timestep_spacing=spacing)
    jsig, jt = js.sigmas_and_timesteps(steps)
    tsig, tt = ts.sigmas_and_timesteps(steps)
    assert tt.dtype == torch.int32 and tsig.dtype == torch.float32
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tsig.numpy(), np.asarray(jsig), atol=0, rtol=3e-6)
    assert tsig[-1] == 0 and tsig.shape == (steps + 1,)
    np.testing.assert_allclose(float(ts.init_noise_sigma(tsig)),
                               float(js.init_noise_sigma(jsig)), rtol=1e-6)


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
def test_euler_step_and_input_scale_match_jax(prediction_type):
    js = jsched.EulerDiscreteScheduler(prediction_type=prediction_type)
    ts = tsched.EulerDiscreteScheduler(prediction_type=prediction_type)
    sig, _ = ts.sigmas_and_timesteps(50)
    eps, x = _randn(5, 1, 4, 4, 4), _randn(6, 1, 4, 4, 4)
    for i in (0, 25, 49):                    # the last step steps to sigma 0
        s, s_next = float(sig[i]), float(sig[i + 1])
        want = js.step(eps, jnp.float32(s), jnp.float32(s_next), x)
        got = ts.step(torch.from_numpy(eps), sig[i], sig[i + 1], torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
        np.testing.assert_allclose(ts.scale_model_input(torch.from_numpy(x), sig[i]).numpy(),
                                   np.asarray(js.scale_model_input(x, jnp.float32(s))),
                                   atol=1e-6, rtol=0)


# ---- attention with its logsumexp ------------------------------------------

@pytest.mark.parametrize("B,T,S,heads,C", [(2, 16, 16, 2, 32), (1, 48, 24, 4, 64),
                                           (3, 9, 5, 1, 8)])
def test_attention_lse_matches_jax(B, T, S, heads, C):
    q, k, v = _randn(1, B, T, C), _randn(2, B, S, C), _randn(3, B, S, C)
    jout, jlse = junet._attention_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads)
    tout, tlse = tattn.attention_with_lse(torch.from_numpy(q), torch.from_numpy(k),
                                          torch.from_numpy(v), heads)
    assert tout.shape == (B, T, C) and tlse.shape == (B, heads, T)
    assert tlse.dtype == torch.float32
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=2e-4, rtol=0)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), atol=2e-4, rtol=0)
    # the plain path it replaces gives the same output
    np.testing.assert_allclose(tout.numpy(), tattn.plain_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), heads).numpy(),
        atol=1e-6, rtol=0)


def test_bank_config_rejects_unknown_forms():
    for impl in ("merge", "concat"):      # the port's bank runs "split" or "self_only"
        with pytest.raises(ValueError, match="impl"):
            with tunet.story_bank_config(impl):
                pass
    with tunet.story_bank_config("self_only"):
        assert tunet._story_bank_impl() == "self_only"
    assert tunet._story_bank_impl() == "split"


# ---- the text_time UNet ----------------------------------------------------

def _unet_inputs(B, seed=0):
    x = _randn(seed, B, 8, 8, 4)
    ctx = _randn(seed + 1, B, 77, 80)
    t = np.arange(B, dtype=np.int32) * 97 + 11
    cond = dict(text_embeds=_randn(seed + 2, B, 48),
                time_ids=np.tile(np.asarray([[16, 16, 0, 0, 16, 16]], np.float32), (B, 1)))
    return x, t, ctx, cond


def _run_both(jpipe, tunet_mod, B, story=None, story_kv=None, seed=0):
    """(port output, JAX output) of one UNet call; the JAX call is jitted
    with `story` and `story_kv` closed over (traced inside the caller's
    story_bank_config)."""
    x, t, ctx, cond = _unet_inputs(B, seed)
    jstory_arg = None if story is None else {
        p: dict(s, indices=jnp.asarray(s["indices"], jnp.int32)) for p, s in story.items()}
    jkv = None if story_kv is None else {p: jnp.asarray(v) for p, v in story_kv.items()}
    want = jax.jit(lambda params, x, t, ctx, cond: jpipe.unet.apply(
        params, x, t, ctx, added_cond=cond, story_kv=jkv, story=jstory_arg))(
        jpipe.unet_params, x, t, ctx, {k: jnp.asarray(v) for k, v in cond.items()})
    return _run_port(tunet_mod, B, story, story_kv, seed), np.asarray(want)


def _run_port(tunet_mod, B, story=None, story_kv=None, seed=0):
    x, t, ctx, cond = _unet_inputs(B, seed)
    tstory_arg = None if story is None else {
        p: dict(s, indices=torch.from_numpy(s["indices"])) for p, s in story.items()}
    tkv = None if story_kv is None else {p: torch.from_numpy(v) for p, v in story_kv.items()}
    with torch.inference_mode():
        return tunet_mod(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                         added_cond={k: torch.from_numpy(v) for k, v in cond.items()},
                         story_kv=tkv, story=tstory_arg).numpy()


def test_text_time_unet_matches_jax(unets):
    jpipe, tunet_mod = unets
    assert tunet_mod.mid_attn is not None         # text_time keeps the mid block's attention
    got, want = _run_both(jpipe, tunet_mod, 2)
    assert got.shape == (2, 8, 8, 4)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


def _tiny_story(num_groups, id_length=2, rows=3, seed=3):
    """story dict of the tiny UNet for `num_groups` groups of `rows` rows."""
    cfg = tunet.unet_tiny(cross_attention_dim=80, addition_embed_type="text_time",
                          projection_dim=96)
    idx = tstory.story_indices(cfg, id_length, (8, 8), 0.5, np.random.default_rng(seed))
    assert sorted(idx) == ["up_0_attn_0", "up_0_attn_1", "up_1_attn_0", "up_1_attn_1"]
    return {p: dict(id_length=id_length, indices=i, num_groups=num_groups)
            for p, i in idx.items()}


@pytest.mark.parametrize("impl", ["split", "concat", "self_only"])
@pytest.mark.parametrize("num_groups", [1, 2])
def test_story_unet_matches_jax(unets, num_groups, impl):
    """`impl` is the JAX bank form; the port runs "split" against the JAX
    package's "split" and "concat" (one softmax over the union of both key
    sets), and "self_only" against "self_only"."""
    jpipe, tunet_mod = unets
    story = _tiny_story(num_groups)
    port_impl = "split" if impl == "concat" else impl
    with junet.story_bank_config(impl=impl), tunet.story_bank_config(port_impl):
        got, want = _run_both(jpipe, tunet_mod, 3 * num_groups, story=story, seed=4)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
    if impl == "self_only":      # the ablation drops the bank: the plain UNet
        plain = _run_port(tunet_mod, 3 * num_groups, seed=4)
        np.testing.assert_allclose(got, plain, atol=1e-5, rtol=0)


def test_split_and_concat_bank_agree(unets, monkeypatch):
    """The split bank against one softmax over the union of both key sets:
    each group's bank broadcast to its rows, put before the row's own keys
    and values, through ``plain_attention``."""

    def concat(q, k, v, ek, ev, heads):
        g, K, C = ek.shape
        rows = q.shape[0] // g
        ekb = ek[:, None].expand(g, rows, K, C).reshape(g * rows, K, C)
        evb = ev[:, None].expand(g, rows, K, C).reshape(g * rows, K, C)
        return tattn.plain_attention(q, torch.cat([ekb, k], dim=1), torch.cat([evb, v], dim=1),
                                     heads)

    _, tunet_mod = unets
    story = {p: dict(s, indices=torch.from_numpy(s["indices"]))
             for p, s in _tiny_story(2).items()}
    x, t, ctx, cond = (torch.from_numpy(a) if isinstance(a, np.ndarray) else
                       {k: torch.from_numpy(v) for k, v in a.items()} for a in _unet_inputs(6))
    outs = {}
    with torch.inference_mode():
        for impl in ("split", "self_only"):
            with tunet.story_bank_config(impl):
                outs[impl] = tunet_mod(x, t, ctx, added_cond=cond, story=story)
        monkeypatch.setattr(tunet, "_bank_attention", concat)
        outs["concat"] = tunet_mod(x, t, ctx, added_cond=cond, story=story)
    torch.testing.assert_close(outs["split"], outs["concat"], atol=2e-5, rtol=0)
    assert (outs["split"] - outs["self_only"]).abs().max() > 1e-4      # the bank matters


@pytest.mark.parametrize("shared", [False, True])
def test_story_kv_on_a_down_block_matches_jax(unets, shared):
    # Extra keys with the batch's own leading dim go in front of each row's
    # keys; with a smaller one (2 groups of 2 rows) they are a group bank.
    jpipe, tunet_mod = unets
    kv = {"down_1_attn_0": _randn(9, 2 if shared else 4, 10, 32),
          "down_0_attn_0": _randn(10, 2 if shared else 4, 7, 16)}
    got, want = _run_both(jpipe, tunet_mod, 4, story_kv=kv, seed=6)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
    plain = _run_port(tunet_mod, 4, seed=6)
    assert np.abs(got - plain).max() > 1e-4


# ---- sampled story indices -------------------------------------------------

def _reference_indices(cfg, id_length, lat_hw, sa_ratio, seed):
    fake = types.SimpleNamespace(unet=types.SimpleNamespace(config=cfg))
    return jstory.StoryXLPipeline._story_indices(fake, id_length, lat_hw, sa_ratio,
                                                 np.random.default_rng(seed))


@pytest.mark.parametrize("full", [False, True])
def test_story_indices_bit_equal_to_jax(full):
    if full:   # the story operating point: SDXL at 768 px, 4 id images, sa_ratio 0.5
        jcfg, tcfg, hw, idl = junet.unet_sdxl(), tunet.unet_sdxl(), (96, 96), 4
    else:
        jcfg = junet.unet_tiny(cross_attention_dim=80, addition_embed_type="text_time",
                               projection_dim=96)
        tcfg = tunet.unet_tiny(cross_attention_dim=80, addition_embed_type="text_time",
                               projection_dim=96)
        hw, idl = (8, 8), 2
    for seed in (0, 7):
        want = _reference_indices(jcfg, idl, hw, 0.5, seed)
        got = tstory.story_indices(tcfg, idl, hw, 0.5, np.random.default_rng(seed))
        assert list(got) == list(want)
        for path in want:
            assert got[path].dtype == np.int64
            np.testing.assert_array_equal(got[path], np.asarray(want[path]))
    if full:
        counts = {p: len(i) for p, i in got.items()}
        assert counts == {**{f"up_0_attn_{j}": 1152 for j in range(3)},
                          **{f"up_1_attn_{j}": 4608 for j in range(3)}}
