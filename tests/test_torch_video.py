"""Parity of the port's video path (temporal attention, the UNet3D pieces and
model, CLIP-H's settings, the ZeroScope pipeline) with the JAX package, in
fp32 on the CPU at tiny widths.

Weights come from the JAX package (its init or numpy draws of its parameter
shapes) through load_jax_params; inputs and latents are made with numpy from
a seed. Tolerances: 2e-5 for temporal attention (the same fp32 softmax over
at most 16 frames, summed in another order; the Pallas kernel in interpret
mode is held to the same figure in tests/test_misc_ops.py); 1e-4 for the
UNet3D pieces and the text encoder (a few fp32 matmuls, convolutions and
norms); 2e-4 for the whole tiny UNet3D (some dozens of layers); 1e-3 for
four CFG denoise steps, where guidance 7.5 amplifies the UNet's
differences; and 1 for the uint8 frames (a value next to a rounding step
may truncate either way).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spider_tpu.models import clip_text as jclip
from spider_tpu.models import unet3d as ju3
from spider_tpu.models.pipelines import vd as jvd
from spider_tpu.models.tokenizer import TinyTokenizer as JaxTinyTokenizer
from spider_tpu.ops import temporal_attention as jta
from spider_tpu_torch.models import clip_text as tclip
from spider_tpu_torch.models import unet3d as tu3
from spider_tpu_torch.models.convert import load_jax_params
from spider_tpu_torch.models.factory import random_init_
from spider_tpu_torch.models.pipelines import vd as tvd
from spider_tpu_torch.models.tokenizer import TinyTokenizer
from spider_tpu_torch.ops import temporal_attention as tta


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _drawn_params(module, *args, scale=0.2, seed=0):
    """numpy N(0, scale) draws of every leaf `module.init` would make, with
    norm scales around 1: larger than the pipelines' 0.02, so a wrong fold
    or normalisation shows."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def fill(path, s):
        x = scale * rng.standard_normal(s.shape, dtype=np.float32)
        return x + 1.0 if jax.tree_util.keystr(path).endswith("['scale']") else x

    return jax.tree_util.tree_map_with_path(fill, shapes)


# ---------------------------------------------------------------------------
# ops/temporal_attention.py
# ---------------------------------------------------------------------------

SHAPES = [(2, 6, 320, 32, 4), (1, 16, 45, 64, 8)]   # B, F, P, C, H


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("layout", ["bfpc", "bpfc"])
@pytest.mark.parametrize("shape", SHAPES)
def test_temporal_attention_reference_matches_jax(shape, layout, use_pallas):
    B, F, P, C, H = shape
    q, k, v = (_randn(s, B, F, P, C) for s in (1, 2, 3))
    if layout == "bpfc":
        q, k, v = (x.transpose(0, 2, 1, 3).copy() for x in (q, k, v))
    # use_pallas=True runs the Pallas kernel in interpret mode on the CPU.
    want = jta.temporal_attention(q, k, v, H, use_pallas=use_pallas, layout=layout)
    got = tta.temporal_attention_reference(*(torch.from_numpy(x) for x in (q, k, v)), H,
                                           layout=layout)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


def test_temporal_attention_on_cpu_takes_plain_path():
    # Inside the kernel's predicate (H*F = 128, P = 45), but on CPU tensors.
    B, F, P, C, H = SHAPES[1]
    assert tta.kernel_predicate(H, F, P, C)
    q, k, v = (torch.from_numpy(_randn(s, B, F, P, C)) for s in (4, 5, 6))
    before = tta.temporal_attention.launches
    got = tta.temporal_attention(q, k, v, H, scale=0.3)
    assert tta.temporal_attention.launches == before
    torch.testing.assert_close(got, tta.temporal_attention_reference(q, k, v, H, scale=0.3),
                               atol=0, rtol=0)
    with pytest.raises(ValueError, match="CUDA"):
        tta.temporal_attention_kernel(q, k, v, H)
    with pytest.raises(ValueError, match="layout"):
        tta.temporal_attention(q, k, v, H, layout="bpcf")


@pytest.mark.parametrize("level,P,C", [(0, 2880, 320), (1, 720, 640), (2, 180, 1280),
                                       ("mid", 45, 1280)])
def test_zeroscope_levels_take_the_kernel(level, P, C):
    # Every UNet3D level at ZeroScope size is inside the reference's
    # predicate (F = 16, H = 8), with head dims the kernel takes.
    assert tta.kernel_predicate(8, 16, P, C)
    assert (C // 8) % 8 == 0 and C // 8 <= tta.MAX_HEAD_DIM


# ---------------------------------------------------------------------------
# models/unet3d.py
# ---------------------------------------------------------------------------

def _to_frames(x):
    """JAX [B, F, H, W, C] -> the port's [B*F, C, H, W]."""
    B, F, H, W, C = x.shape
    return torch.from_numpy(x.reshape(B * F, H, W, C).transpose(0, 3, 1, 2).copy())


def _from_frames(t, shape):
    B, F, H, W, C = shape
    return t.numpy().transpose(0, 2, 3, 1).reshape(B, F, H, W, C)


@pytest.mark.parametrize("kind", ["tconv", "ttrans"])
def test_temporal_pieces_match_jax(kind):
    # B = 2 videos with different content: a per-frame GroupNorm or an
    # f-major fold would mix or split them and fail here.
    x = _randn(7, 2, 6, 4, 4, 16)
    if kind == "tconv":
        jm, tm = ju3.TemporalConv(16, 4, jnp.float32), tu3.TemporalConv(16, 4, torch.float32)
    else:
        jm = ju3.TransformerTemporal(2, 4, jnp.float32)
        tm = tu3.TransformerTemporal(16, 2, 4, torch.float32)
    params = _drawn_params(jm, x)
    load_jax_params(tm, params)
    want = jm.apply(params, x)
    with torch.no_grad():
        got = tm(_to_frames(x), 6)
    np.testing.assert_allclose(_from_frames(got, x.shape), np.asarray(want), atol=1e-4,
                               rtol=0)


@pytest.fixture(scope="module")
def pipes():
    """(JAX tiny vd pipeline, port tiny vd pipeline) with the same weights:
    the JAX package's random_params_like init, carried across as numpy."""
    jpipe = jvd.build_tiny_vd(tokenizer=JaxTinyTokenizer())
    tpipe = tvd.build_tiny_vd(tokenizer=TinyTokenizer(), device="cpu")
    load_jax_params(tpipe.text_encoder, _np_tree(jpipe.text_params))
    load_jax_params(tpipe.unet, _np_tree(jpipe.unet_params))
    load_jax_params(tpipe.vae, _np_tree(jpipe.vae_params))
    return jpipe, tpipe


def test_unet3d_tiny_matches_jax(pipes):
    jpipe, tpipe = pipes
    x, ctx = _randn(8, 2, 3, 8, 8, 4), _randn(9, 2, 7, 32)
    t = np.array([981, 15], np.int32)
    want = jax.jit(jpipe.unet.apply)(jpipe.unet_params, x, t, ctx)
    with torch.no_grad():
        got = tpipe.unet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    assert got.shape == (2, 3, 8, 8, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)


def _channels_last(t):
    return t.is_contiguous(memory_format=torch.channels_last)


def _in_place(views, video_view):
    """`video_view` that appends whether its result shares x's storage."""
    def view(x, frames):
        out = video_view(x, frames)
        views.append(out.untyped_storage().data_ptr() == x.untyped_storage().data_ptr())
        return out
    return view


def test_unet3d_keeps_channels_last_through_its_temporal_layers(pipes, monkeypatch):
    # Every temporal layer reads the spatial layers' storage in place, and
    # every convolution (the skips' 1x1 shortcuts after torch.cat, the
    # upsamples after F.interpolate, the stride-2 downsamples) takes and
    # gives channels-last.
    unet = pipes[1].unet
    seen, inputs, views = [], [], []
    temporal = [m for m in unet.modules()
                if isinstance(m, (tu3.TemporalConv, tu3.TransformerTemporal))]
    hooks = [m.register_forward_hook(lambda m, a, o: seen.append(
        (type(m).__name__, _channels_last(a[0]), _channels_last(o))))
        for m in unet.modules()
        if isinstance(m, (tu3.TemporalConv, tu3.TransformerTemporal, torch.nn.Conv2d))]
    hooks += [m.register_forward_pre_hook(lambda m, a: inputs.append(_channels_last(a[0])))
              for m in temporal]
    monkeypatch.setattr(tu3, "_video_view", _in_place(views, tu3._video_view))
    try:
        with torch.no_grad():
            unet(torch.from_numpy(_randn(10, 2, 3, 8, 8, 4)), torch.tensor([981, 15]),
                 torch.from_numpy(_randn(11, 2, 7, 32)))
    finally:
        for h in hooks:
            h.remove()
    assert len(seen) == len(hooks) - len(temporal) and all(a and o for _, a, o in seen), seen
    assert len(temporal) == 16 and sum(name != "Conv2d" for name, _, _ in seen) == 16
    assert inputs == [True] * 16
    assert views == [True] * 16


@pytest.mark.parametrize("layout", ["channels_last", "contiguous"])
def test_video_view_reads_channels_last_in_place_and_copies_others(layout):
    x = torch.from_numpy(_randn(12, 6, 8, 4, 5))                     # B 2, F 3
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    want = x.contiguous().reshape(2, 3, 8, 20).transpose(1, 2)
    got = tu3._video_view(x, 3)
    assert torch.equal(got, want)
    if layout == "channels_last":
        assert got.data_ptr() == x.data_ptr() and _channels_last(got)
        assert got.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()


@pytest.mark.parametrize("load", ["load_jax_params", "load_state_dict"])
def test_unet3d_conv_weights_stay_channels_last_when_loaded(pipes, load):
    jpipe, tpipe = pipes
    if load == "load_jax_params":
        unet, params = tpipe.unet, jpipe.unet_params
        params = params.get("params", params)
        want = {}
        for name, t in unet.state_dict().items():
            if t.dim() == 4:
                node = params
                for key in name.split(".")[:-1]:
                    node = node[key]
                want[name] = torch.from_numpy(np.asarray(node["kernel"]).transpose(3, 2, 0, 1))
    else:
        unet = tu3.UNet3DConditionModel(tu3.unet3d_tiny())
        want = {n: torch.from_numpy(_randn(i, *t.shape))
                for i, (n, t) in enumerate(unet.state_dict().items())}
        unet.load_state_dict(want)
    convs = {n: t for n, t in unet.state_dict().items() if t.dim() == 4}
    assert len(convs) == sum(isinstance(m, torch.nn.Conv2d) for m in unet.modules())
    assert any(not t.is_contiguous() for t in convs.values())     # 1x1 kernels are both
    for name, t in convs.items():
        assert _channels_last(t) and torch.equal(t, want[name]), name


def test_random_init_does_not_depend_on_the_memory_format():
    gen = lambda: torch.Generator().manual_seed(3)
    cl = random_init_(tu3.UNet3DConditionModel(tu3.unet3d_tiny()), gen())
    nchw = random_init_(tu3.UNet3DConditionModel(tu3.unet3d_tiny())
                        .to(memory_format=torch.contiguous_format), gen())
    a, b = cl.state_dict(), nchw.state_dict()
    assert any(_channels_last(t) and not t.is_contiguous() for t in a.values())
    assert all(torch.equal(a[n], b[n]) for n in a)


def test_zeroscope_unet3d_runs_34_temporal_attentions_per_call():
    # On the meta device: the full-size module tree, no memory.
    unet = tu3.UNet3DConditionModel(tu3.unet3d_zeroscope(), device="meta")
    assert sum(isinstance(m, tu3.TransformerTemporal) for m in unet.modules()) == 17
    assert dataclasses.asdict(tu3.unet3d_zeroscope()) == {
        **dataclasses.asdict(ju3.unet3d_zeroscope()), "dtype": torch.float32}


# ---------------------------------------------------------------------------
# models/clip_text.py: the video stage's text encoder settings
# ---------------------------------------------------------------------------

def test_clip_vit_h14_and_gelu_match_jax():
    assert ({k: v for k, v in dataclasses.asdict(tclip.clip_vit_h14()).items() if k != "dtype"}
            == {k: v for k, v in dataclasses.asdict(jclip.clip_vit_h14()).items()
                if k not in ("dtype", "param_dtype")})
    jcfg = dataclasses.replace(jclip.clip_tiny(300), hidden_act="gelu")
    tcfg = dataclasses.replace(tclip.clip_tiny(300), hidden_act="gelu")
    ids = np.random.default_rng(10).integers(3, 300, size=(2, 9)).astype(np.int32)
    jm = jclip.CLIPTextModel(jcfg)
    params = _drawn_params(jm, ids, scale=0.1)
    tm = load_jax_params(tclip.CLIPTextModel(tcfg), params)
    want = jm.apply(params, ids)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# models/pipelines/vd.py
# ---------------------------------------------------------------------------

def test_vd_denoise_and_decode_on_injected_latents_match_jax(pipes):
    jpipe, tpipe = pipes
    prompts = ["a horse running on a beach"]
    np.testing.assert_array_equal(tpipe.tokenize(prompts).numpy(),
                                  np.asarray(jpipe.tokenize(prompts)))
    cond = np.asarray(jpipe.encode_prompt(prompts))
    uncond = np.asarray(jpipe.encode_prompt([""]))
    np.testing.assert_allclose(tpipe.encode_prompt(prompts).numpy(), cond, atol=1e-4, rtol=0)
    lat = _randn(11, 1, 3, 8, 8, 4)
    want = jpipe._denoise_fn(4, 7.5, lat.shape)(jpipe.unet_params, lat, cond, uncond,
                                                jax.random.PRNGKey(0))
    got = tpipe._denoise_fn(4, 7.5, lat.shape)(torch.from_numpy(lat), torch.tensor(cond),
                                               torch.tensor(uncond))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=0)
    # The JAX pipeline's decode: frames folded into the batch, uint8.
    flat = np.asarray(want).reshape(3, 8, 8, 4)
    img = jpipe.vae.apply(jpipe.vae_params, flat, method=jpipe.vae.decode)
    want_frames = np.asarray(((img / 2 + 0.5).clip(0.0, 1.0) * 255.0).astype(jnp.uint8))
    frames = tpipe._decode_latents(torch.tensor(np.asarray(want)))
    assert frames.dtype == np.uint8 and frames.shape == (1, 3, 16, 16, 3)
    diff = np.abs(frames.astype(np.int16) - want_frames.reshape(frames.shape).astype(np.int16))
    assert diff.max() <= 1


def test_vd_call_with_injected_latents_returns_uint8_frames(pipes):
    _, tpipe = pipes
    lat = torch.from_numpy(_randn(12, 1, 2, 8, 8, 4))
    out = tpipe(prompt=["a cat"], num_inference_steps=2, height=16, width=16, num_frames=2,
                latents=lat)
    assert out.dtype == np.uint8 and out.shape == (1, 2, 16, 16, 3)
    with pytest.raises(ValueError, match="latents"):
        tpipe(prompt=["a cat"], num_inference_steps=2, height=16, width=16, num_frames=3,
              latents=lat)
