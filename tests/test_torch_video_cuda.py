"""The UNet3D's one activation layout on the card: a bf16 call at ZeroScope's
widths (CFG batch 2, 16 frames, 16 x 24 latents) keeps every activation
and convolution channels-last, its temporal layers read the spatial layers'
storage in place (all 39 of ``_video_view``'s results share their input's
storage), and it agrees with the same call whose temporal layers copy to NCHW.

These tests need an NVIDIA GPU (the GroupNorm, flash and temporal attention
kernels the call runs have no CPU mode), so without a card they skip. They
import torch only: ``python -m pytest --noconftest tests/test_torch_video_cuda.py``.

Tolerance: both bf16 calls are held to an fp32 copy on the plain routes,
the channels-last one at most 1.5x (plus 1e-3) as far from it as the copying
one, chip_smoke's unet_check rule, and the two within 0.04 of each other,
half the benchmark's ``unet_rel_l2`` limit. cuDNN picks other algorithms for
the two layouts, so their roundings differ; a wrong stride or fold moves the
output by its own size.
"""

import dataclasses

import pytest
import torch

from spider_tpu_torch.models import unet3d as u3
from spider_tpu_torch.ops.attention import spatial_flash_config
from spider_tpu_torch.ops.group_norm import group_norm_config
from spider_tpu_torch.ops.temporal_attention import temporal_attention_config

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def call():
    """(bf16 model, fp32 copy, latents, timesteps, context) on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the UNet3D's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = u3.UNet3DConfig(dtype=torch.bfloat16)
    model = u3.UNet3DConditionModel(cfg, dev).eval()
    g = torch.Generator(device=dev).manual_seed(23)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g, device=dev) * 0.02)
        for m in model.modules():
            if isinstance(m, (torch.nn.GroupNorm, torch.nn.LayerNorm)):
                m.weight.add_(1.0)
    ref = u3.UNet3DConditionModel(dataclasses.replace(cfg, dtype=torch.float32), dev).eval()
    ref.load_state_dict(model.state_dict())
    lat = torch.randn((2, 16, 16, 24, 4), generator=g, device=dev)
    t = torch.full((2,), 981, dtype=torch.int32, device=dev)
    ctx = torch.randn((2, 77, 1024), generator=g, device=dev)
    return model, ref, lat, t, ctx


def _channels_last(t):
    return t.is_contiguous(memory_format=torch.channels_last)


def test_conv_weights_are_channels_last_on_the_card(call):
    model, ref = call[:2]
    for m in (model, ref):
        convs = [c.weight for c in m.modules() if isinstance(c, torch.nn.Conv2d)]
        assert convs and all(_channels_last(w) for w in convs)


def _in_place(views, video_view):
    """`video_view` that appends whether its result shares x's storage."""
    def view(x, frames):
        out = video_view(x, frames)
        views.append(out.untyped_storage().data_ptr() == x.untyped_storage().data_ptr())
        return out
    return view


def test_a_call_keeps_channels_last_and_reads_in_place(call, monkeypatch):
    model, _, lat, t, ctx = call
    seen, inputs, views = [], [], []
    temporal = [m for m in model.modules()
                if isinstance(m, (u3.TemporalConv, u3.TransformerTemporal))]
    hooks = [m.register_forward_hook(lambda m, a, o: seen.append(
        (type(m).__name__, _channels_last(a[0]), _channels_last(o))))
        for m in model.modules()
        if isinstance(m, (u3.TemporalConv, u3.TransformerTemporal, torch.nn.Conv2d))]
    hooks += [m.register_forward_pre_hook(lambda m, a: inputs.append(_channels_last(a[0])))
              for m in temporal]
    monkeypatch.setattr(u3, "_video_view", _in_place(views, u3._video_view))
    try:
        with torch.inference_mode():
            out = model(lat.bfloat16(), t, ctx.bfloat16())
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    assert torch.isfinite(out).all() and out.is_contiguous()
    assert len(seen) == len(hooks) - len(temporal) and all(a and o for _, a, o in seen), \
        [s for s in seen if not (s[1] and s[2])]
    assert seen[-1][0] == "Conv2d"                         # conv_out, before the exit permute
    assert inputs == [True] * len(temporal)
    assert views == [True] * 39


def test_a_call_agrees_with_temporal_layers_that_copy(call, monkeypatch):
    model, ref_model, lat, t, ctx = call
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    with torch.inference_mode():
        views = []
        monkeypatch.setattr(u3, "_video_view", _in_place(views, u3._video_view))
        in_place = model(lat.bfloat16(), t, ctx.bfloat16()).float()
        assert views == [True] * 39
        monkeypatch.undo()
        copies = []

        def copying(x, frames):            # the form before channels-last: always a copy
            BF, C, H, W = x.shape
            copies.append(x.shape)
            return x.reshape(BF // frames, frames, C, H * W).transpose(1, 2).contiguous()

        monkeypatch.setattr(u3, "_video_view", copying)
        copied = model(lat.bfloat16(), t, ctx.bfloat16()).float()
        assert len(copies) == 39
        monkeypatch.undo()
        with temporal_attention_config("plain"), group_norm_config("plain"), \
                spatial_flash_config("einsum"):
            ref = ref_model(lat, t, ctx)
    assert torch.isfinite(in_place).all()
    err_in_place, err_copied = rel(in_place, ref), rel(copied, ref)
    assert err_in_place <= 1.5 * err_copied + 1e-3, (err_in_place, err_copied)
    assert rel(in_place, copied) <= 0.04, rel(in_place, copied)
