"""The GroupNorm kernel (csrc/group_norm.cu) against fp32 ``F.group_norm``.

Every GroupNorm shape the two benchmark cells run (the UNet3D's 18 at
ZeroScope's 576x320 x 16 frames with CFG, the UNet2D's at SD-1.5's 512 px
with CFG, the SD VAE decoder's for 16 frames at 576x320 and one image at
512 px), with and without the fused SiLU, at both eps the models use; then
offset rows, odd sizes, layouts, the same bits twice, the launch counter in
whole UNet calls, the gradient through the kernel route and one whole
UNet3D call against the plain route.

These tests need an NVIDIA GPU: the kernel has no CPU mode, so without a
card they skip. They import torch only, so they also run where JAX is not
installed: ``python -m pytest --noconftest tests/test_torch_group_norm_cuda.py``.

Tolerances: the kernel (bf16 only) and the fp32 reference both take the
moments in fp32 (in other orders), so they differ by a few fp32 ulps before
the kernel rounds its result once to bf16: half a step, 2^-9 relative, held
to one step (2^-8) of |reference| plus 1e-4 (``__expf`` and ``rsqrtf`` are
within 2 ulps).
"""

import dataclasses

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from spider_tpu_torch.ops import group_norm as GN
from spider_tpu_torch.ops.launch import reset_launches

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the GroupNorm kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


UNET3D_SHAPES = [(2, 320, 16, 2880), (32, 320, 40, 72), (32, 320, 20, 36), (32, 640, 20, 36),
                 (2, 640, 16, 720), (32, 640, 10, 18), (32, 1280, 10, 18), (2, 1280, 16, 180),
                 (32, 1280, 5, 9), (2, 1280, 16, 45), (32, 2560, 5, 9), (32, 2560, 10, 18),
                 (32, 1920, 10, 18), (32, 1920, 20, 36), (32, 1280, 20, 36), (32, 960, 20, 36),
                 (32, 960, 40, 72), (32, 640, 40, 72)]
UNET2D_SHAPES = [(2, 320, 64, 64), (2, 320, 32, 32), (2, 640, 32, 32), (2, 640, 16, 16),
                 (2, 1280, 16, 16), (2, 1280, 8, 8), (2, 2560, 8, 8), (2, 2560, 16, 16),
                 (2, 1920, 16, 16), (2, 1920, 32, 32), (2, 1280, 32, 32), (2, 960, 32, 32),
                 (2, 960, 64, 64), (2, 640, 64, 64)]
VAE_SHAPES = [(16, 512, 40, 72), (16, 512, 80, 144), (16, 512, 160, 288), (16, 256, 160, 288),
              (16, 256, 320, 576), (16, 128, 320, 576), (1, 512, 64, 64), (1, 512, 128, 128),
              (1, 512, 256, 256), (1, 256, 256, 256), (1, 256, 512, 512), (1, 128, 512, 512)]
ATOL, RTOL = 1e-4, 2.0 ** -8


def _inputs(shape, dtype, dev, seed, offset=0.0):
    """x with a mean and a spread of its own in every channel, and the
    norm's weight and bias."""
    g = torch.Generator(device=dev).manual_seed(seed)
    C = shape[1]
    view = (1, C) + (1,) * (len(shape) - 2)
    mean = (torch.rand(C, generator=g, device=dev) * 4 - 2).view(view) + offset
    std = (torch.rand(C, generator=g, device=dev) * 1.5 + 0.5).view(view)
    x = (torch.randn(shape, generator=g, device=dev) * std + mean).to(dtype)
    w = (1 + 0.3 * torch.randn(C, generator=g, device=dev)).to(dtype)
    b = (0.3 * torch.randn(C, generator=g, device=dev)).to(dtype)
    return x, w, b


def _want(x, groups, w, b, eps, silu):
    y = F.group_norm(x.float(), groups, w.float(), b.float(), eps)
    return F.silu(y) if silu else y


def _excess(out, want):
    return ((out.to(want.dtype) - want).abs() - (ATOL + RTOL * want.abs())).max().item()


def _kernel(x, groups, w, b, eps, silu):
    before = GN.group_norm.route_launches["split"]
    out = GN.group_norm_kernel(x, groups, w, b, eps, silu=silu)
    torch.cuda.synchronize()
    assert GN.group_norm.route_launches["split"] == before + 1
    assert out.shape == x.shape and out.dtype == x.dtype and torch.isfinite(out).all()
    return out


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("shape", UNET3D_SHAPES + UNET2D_SHAPES + VAE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_every_cell_shape(dev, shape, silu, eps):
    x, w, b = _inputs(shape, torch.bfloat16, dev, seed=hash(shape) % 1000)
    out = _kernel(x, 32, w, b, eps, silu)
    assert _excess(out, _want(x, 32, w, b, eps, silu)) <= 0


@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("shape", [(2, 320, 16, 2880), (32, 640, 20, 36), (4, 64, 33, 17)])
def test_rows_far_from_zero(dev, shape, silu):
    """Mean 100, spread about 1: one-pass sums of squares would lose the
    variance; Welford/Chan keeps it, and the mean is taken off before the
    scale. Held to fp64: fp32 F.group_norm's own x * a + b form is off by
    about 100 fp32 ulps of a here."""
    x, w, b = _inputs(shape, torch.bfloat16, dev, seed=5, offset=100.0)
    out = _kernel(x, 32, w, b, 1e-6, silu)
    want = F.group_norm(x.double(), 32, w.double(), b.double(), 1e-6)
    assert _excess(out, F.silu(want) if silu else want) <= 0


@pytest.mark.parametrize("shape,groups", [
    ((3, 6, 7, 5), 3),          # rows of 70: not a multiple of a vector, rows misaligned
    ((2, 12, 1001), 4),         # 3-D, rows of 3003
    ((2, 64, 9, 9), 64),        # C / G = 1
    ((5, 40), 8),               # 2-D: L = 1
    ((1, 8, 3, 3, 3), 2),       # 5-D
    ((2, 4, 3), 1),             # fewer elements than a vector
    ((1, 32, 1 << 20), 1),      # one row of 32 M elements over many chunks
])
def test_odd_sizes(dev, shape, groups):
    x, w, b = _inputs(shape, torch.bfloat16, dev, seed=6)
    for silu in (False, True):
        out = _kernel(x, groups, w, b, 1e-5, silu)
        assert _excess(out, _want(x, groups, w, b, 1e-5, silu)) <= 0


def test_misaligned_storage_and_no_affine(dev):
    x, w, b = _inputs((4, 32, 11, 13), torch.bfloat16, dev, seed=7)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
    flat[1:].copy_(x.reshape(-1))
    shifted = flat[1:].view(x.shape)          # 2 bytes past a 16-byte boundary
    assert shifted.data_ptr() % 16
    out = _kernel(shifted, 8, w, b, 1e-5, True)
    assert _excess(out, _want(x, 8, w, b, 1e-5, True)) <= 0
    out = _kernel(x, 8, None, None, 1e-5, False)
    want = F.group_norm(x.float(), 8, None, None, 1e-5)
    assert _excess(out, want) <= 0
    out = _kernel(x, 8, w.float(), b.double(), 1e-5, True)       # cast to bf16
    assert torch.equal(out, _kernel(x, 8, w, b, 1e-5, True))


@pytest.mark.parametrize("shape", [(32, 320, 40, 72), (2, 2560, 8, 8), (32, 1280, 5, 9),
                                   (4, 4096, 4, 4), (2, 8192, 2, 2), (16, 128, 80, 144)])
def test_layouts(dev, shape):
    """Channels-last inputs are read in place and give channels-last
    outputs (beyond the kernel's most threads a block in vectors of
    channels they are copied to contiguous); other strides are copied;
    every form agrees with the contiguous one."""
    dtype = torch.bfloat16
    x, w, b = _inputs(shape, dtype, dev, seed=8)
    want = _want(x, 32, w, b, 1e-5, True)
    base = _kernel(x, 32, w, b, 1e-5, True)
    cl = x.contiguous(memory_format=torch.channels_last)
    out = _kernel(cl, 32, w, b, 1e-5, True)
    in_place = shape[1] // GN.VEC <= GN._function()[1][1]
    assert in_place == (shape[1] <= 4096)
    assert (out.stride() == cl.stride()) == in_place
    assert _excess(out, want) <= 0
    assert _excess(base, want) <= 0
    assert (out.float() - base.float()).abs().max().item() <= 2 * RTOL * (
        want.abs().max().item() + 1)
    strided = torch.empty(shape[:-1] + (2 * shape[-1],), dtype=dtype, device=dev)[..., ::2]
    strided.copy_(x)
    out = _kernel(strided, 32, w, b, 1e-5, True)
    assert out.is_contiguous() and torch.equal(out, base)


def test_channels_last_3d(dev):
    x, w, b = _inputs((2, 64, 4, 6, 10), torch.bfloat16, dev, seed=9)
    cl = x.contiguous(memory_format=torch.channels_last_3d)
    out = _kernel(cl, 32, w, b, 1e-6, False)
    assert out.stride() == cl.stride()
    assert _excess(out, _want(x, 32, w, b, 1e-6, False)) <= 0


@pytest.mark.parametrize("layout", ["contiguous", "channels_last"])
def test_same_bits_twice(dev, layout):
    x, w, b = _inputs((2, 320, 16, 2880) if layout == "contiguous" else (32, 320, 40, 72),
                      torch.bfloat16, dev, seed=10)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    first = _kernel(x, 32, w, b, 1e-5, True)
    assert torch.equal(first, _kernel(x, 32, w, b, 1e-5, True))


def test_wrapper_routes_and_raises(dev):
    """bf16 takes the kernel with or without a gradient to keep; fp32 and
    fp64 (the reference copies) and the "plain" override take the plain
    form, which counts nothing; the kernel raises on what it does not take."""
    x, w, b = _inputs((2, 64, 8, 8), torch.bfloat16, dev, seed=11)
    norm = nn.GroupNorm(32, 64, eps=1e-5, device=dev, dtype=torch.bfloat16)
    with torch.no_grad():
        norm.weight.copy_(w)
        norm.bias.copy_(b)
    reset_launches(GN.group_norm)
    with torch.inference_mode():
        GN.group_norm(x, norm, silu=True)
    GN.group_norm(x, norm)                       # weight requires grad: GroupNormFunction
    assert GN.group_norm.route_launches == {"split": 2}
    with torch.no_grad():
        GN.group_norm(x.double(), norm.double())  # fp64: the plain form
        GN.group_norm(x.float(), norm.float())    # fp32: the plain form
        with GN.group_norm_config("plain"):
            GN.group_norm(x, norm.bfloat16())
    assert GN.group_norm.route_launches == {"split": 2} and GN.group_norm.launches == 2
    with pytest.raises(ValueError):
        GN.group_norm_kernel(x, 24, w, b)
    with pytest.raises(ValueError):
        GN.group_norm_kernel(x, 32, w[:32], b)
    with pytest.raises(TypeError):
        GN.group_norm_kernel(x.float(), 32)
    with pytest.raises(ValueError):
        GN.group_norm_kernel(x.cpu(), 32)


@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("shape", [(2, 320, 16, 2880), (32, 640, 20, 36)])
def test_gradient_through_the_kernel_route(dev, shape, silu):
    """With a gradient to keep, the forward is the kernel's and the
    backward the plain form's: x, weight and bias get the gradients of the
    same graph through F.group_norm (then F.silu), bit for bit, and the
    output is the kernel's."""
    x0, w, b = _inputs(shape, torch.bfloat16, dev, seed=14)
    norm = nn.GroupNorm(32, shape[1], eps=1e-6, device=dev, dtype=torch.bfloat16)
    with torch.no_grad():
        norm.weight.copy_(w)
        norm.bias.copy_(b)
    up = torch.randn(shape, device=dev, dtype=torch.bfloat16)

    def grads(route):
        x = x0.clone().requires_grad_()
        norm.zero_grad()
        with GN.group_norm_config(route):
            y = GN.group_norm(x, norm, silu=silu)
        (y * up).float().sum().backward()
        return y.detach(), x.grad, norm.weight.grad, norm.bias.grad

    before = GN.group_norm.launches
    got = grads("auto")
    assert GN.group_norm.launches == before + 1
    want = grads("plain")
    assert torch.equal(got[0], _kernel(x0, 32, w, b, 1e-6, silu))
    for g, h in zip(got[1:], want[1:]):
        assert torch.equal(g, h)


def _random_norms_(model, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.GroupNorm):
                mod.weight.copy_(1 + 0.2 * torch.randn(mod.weight.shape, generator=g))
                mod.bias.copy_(0.2 * torch.randn(mod.bias.shape, generator=g))


def test_unet_calls_take_the_split_route(dev, monkeypatch):
    """Every GroupNorm of a UNet3D call at ZeroScope's widths, of a UNet2D
    call at SD-1.5's and of the SD VAE's decode takes the kernel: 166, 60
    and 30 launches, and no call of the plain form."""
    from spider_tpu_torch.models.unet2d import UNet2DConditionModel, UNet2DConfig
    from spider_tpu_torch.models.unet3d import UNet3DConditionModel, UNet3DConfig
    from spider_tpu_torch.models.vae import AutoencoderKL, VAEConfig

    plain = []
    real_plain = GN._plain
    monkeypatch.setattr(GN, "_plain", lambda *a: plain.append(a) or real_plain(*a))
    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(12)
    t = torch.full((2,), 501, dtype=torch.int32, device=dev)
    for model, sample, ctx, want in (
            (UNet3DConditionModel(UNet3DConfig(dtype=bf), dev), (2, 4, 16, 24, 4), 1024, 166),
            (UNet2DConditionModel(UNet2DConfig(dtype=bf), dev), (2, 32, 32, 4), 768, 60)):
        lat = torch.randn(sample, generator=g, device=dev, dtype=bf)
        enc = torch.randn((2, 77, ctx), generator=g, device=dev, dtype=bf)
        reset_launches(GN.group_norm)
        with torch.inference_mode():
            out = model.eval()(lat, t, enc)
        torch.cuda.synchronize()
        assert torch.isfinite(out).all()
        assert GN.group_norm.route_launches == {"split": want} and not plain
        del model
    vae = AutoencoderKL(VAEConfig(dtype=bf), dev).eval()
    reset_launches(GN.group_norm)
    with torch.inference_mode():
        out = vae.decode(torch.randn((1, 16, 16, 4), generator=g, device=dev, dtype=bf))
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert GN.group_norm.route_launches == {"split": 30} and not plain


def test_unet3d_call_against_the_plain_route(dev):
    """One whole ZeroScope UNet3D call (CFG batch 2, 16 frames, 40 x 72
    latents) through the kernel and through the plain route, each against
    an fp32 copy on the plain route: the kernel may be at most 1.5x (plus
    1e-3) as far from fp32 as the plain route, chip_smoke's unet_check rule,
    and within 0.04 of the plain route, half the benchmark's unet_rel_l2
    limit."""
    from spider_tpu_torch.models.unet3d import UNet3DConditionModel, UNet3DConfig

    cfg = UNet3DConfig(dtype=torch.bfloat16)
    model = UNet3DConditionModel(cfg, dev).eval()
    _random_norms_(model, 13)
    g = torch.Generator(device=dev).manual_seed(13)
    lat = torch.randn((2, 16, 40, 72, 4), generator=g, device=dev)
    enc = torch.randn((2, 77, 1024), generator=g, device=dev)
    t = torch.full((2,), 981, dtype=torch.int32, device=dev)
    rel = lambda a, ref: ((a - ref).norm() / ref.norm()).item()
    with torch.inference_mode():
        split = model(lat.bfloat16(), t, enc.bfloat16()).float()
        with GN.group_norm_config("plain"):
            plain = model(lat.bfloat16(), t, enc.bfloat16()).float()
        ref_model = UNet3DConditionModel(dataclasses.replace(cfg, dtype=torch.float32), dev).eval()
        ref_model.load_state_dict(model.state_dict())
        del model
        ref = ref_model(lat, t, enc)
    assert torch.isfinite(split).all()
    err_split, err_plain = rel(split, ref), rel(plain, ref)
    assert err_split <= 1.5 * err_plain + 1e-3, (err_split, err_plain)
    assert rel(split, plain) <= 0.04, rel(split, plain)
