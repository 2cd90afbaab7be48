"""ops/group_norm.py on the CPU: the routing rule, the plain route against
``F.silu(norm(x))`` bit for bit, the chunk plan, the layout test, and the
diffusion models' GroupNorms all going through the wrapper with their state
dicts as they were. The kernel itself runs only on the card
(tests/test_torch_group_norm_cuda.py); the models' parity with the JAX
package is held by tests/test_torch_sd.py and tests/test_torch_video.py."""

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from spider_tpu_torch.models import unet2d, unet3d, vae
from spider_tpu_torch.ops import group_norm as GN
from spider_tpu_torch.ops.launch import reset_launches

# The library's threads a block (csrc/group_norm.cu's CONTIG_THREADS and
# MAX_CL_THREADS, which the wrapper reads from it on the card).
THREADS, MAX_CL_THREADS = 256, 512
LIMITS = (THREADS, MAX_CL_THREADS)


class _Seen:
    """What ``kernel_takes`` reads of a tensor, for a CUDA tensor this
    machine may not have."""

    def __init__(self, dtype=torch.bfloat16, is_cuda=True):
        self.dtype, self.is_cuda = dtype, is_cuda


def test_routing_rule():
    """bf16 CUDA tensors take the kernel, with or without a gradient to
    keep; the CPU, other dtypes (the fp32 reference copies) and the "plain"
    override take the plain form."""
    assert GN.kernel_takes(_Seen())
    assert not GN.kernel_takes(_Seen(is_cuda=False))              # the CPU
    for dtype in (torch.float32, torch.float16, torch.float64):
        assert not GN.kernel_takes(_Seen(dtype))
    with GN.group_norm_config("plain"):
        assert not GN.kernel_takes(_Seen())
        with GN.group_norm_config("auto"):
            assert GN.kernel_takes(_Seen())
    assert GN.kernel_takes(_Seen())
    with pytest.raises(ValueError):
        with GN.group_norm_config("einsum"):
            pass


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["contiguous", "channels_last", "strided"])
def test_plain_route_is_the_old_form_bit_for_bit(dtype, layout):
    torch.manual_seed(0)
    x = torch.randn(3, 16, 6, 10, dtype=dtype) * 3 + 1
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    elif layout == "strided":
        x = x[:, :, :, ::2]
    norm = nn.GroupNorm(4, 16, eps=1e-6, dtype=dtype)
    with torch.no_grad():
        norm.weight.normal_(1, 0.3)
        norm.bias.normal_(0, 0.3)
    reset_launches(GN.group_norm)
    assert torch.equal(GN.group_norm(x, norm, silu=True), F.silu(norm(x)))
    assert torch.equal(GN.group_norm(x, norm), norm(x))
    assert GN.group_norm.launches == 0 and GN.group_norm.route_launches == {"split": 0}


def test_plain_route_keeps_the_gradient():
    torch.manual_seed(1)
    x = torch.randn(2, 8, 5, requires_grad=True)
    norm = nn.GroupNorm(2, 8)
    GN.group_norm(x, norm, silu=True).square().sum().backward()
    gx, gw = x.grad.clone(), norm.weight.grad.clone()
    x.grad = None
    norm.zero_grad()
    F.silu(norm(x)).square().sum().backward()
    assert torch.equal(gx, x.grad) and torch.equal(gw, norm.weight.grad)


CL_320 = GN.cl_workers(320)


@pytest.mark.parametrize("rows,units,unit_elems,threads,align", [
    (64, 460800, 1, THREADS, 8),      # ZeroScope per-video norm, level 0
    (64, 11520 * 20, 1, THREADS, 8),  # level 1
    (1024, 28800, 1, THREADS, 8),     # per-frame, level 0
    (1024, 1800, 1, THREADS, 8),      # per-frame, the 5 x 9 level
    (512, 737280, 1, THREADS, 8),     # VAE, 16 frames at 576 x 320
    (32, 2880, 320, CL_320, 1),          # channels-last per-frame, level 0
    (32, 45, 2560, GN.cl_workers(2560), 1),  # channels-last, up block concat at 5 x 9
    (2, 64, 1280, GN.cl_workers(1280), 1),
    (3, 70, 1, THREADS, 8),           # a row shorter than a chunk
    (1, 1, 40, 128, 1),
    (64, 40960, 1, THREADS, 8),       # SD-1.5 level 0: a wave before large chunks
])
def test_split_plan(rows, units, unit_elems, threads, align):
    sms = 132
    chunks, per = GN.split_plan(rows, units, unit_elems, sms, threads, align)
    assert chunks >= 1 and per >= 1 and per % align == 0
    assert (chunks - 1) * per < units <= chunks * per       # every chunk holds some
    if chunks > 1:                                            # no small chunks
        assert per * unit_elems >= 16 * threads
        assert (per * unit_elems >= GN.MIN_PER_THREAD * threads
                or rows * chunks <= GN.WAVE_PER_SM * sms + rows)     # small only to fill a wave
    assert chunks <= -(-GN.BLOCKS_PER_SM * sms // rows)       # no more than the card needs


def test_split_plan_fills_the_card_for_the_per_video_norms():
    """64 rows of 0.46 M elements: many more blocks than the 132 SMs, which
    one block a row left idle."""
    chunks, per = GN.split_plan(64, 460800, 1, 132, THREADS, 8)
    assert 64 * chunks >= 4 * 132 and per >= GN.MIN_PER_THREAD * THREADS


@pytest.mark.parametrize("C", [320, 1280, 2560, 4096, 128, 1920])
def test_channels_last_threads_hold_fixed_channels(C):
    workers = GN.cl_workers(C)
    assert workers % (C // GN.VEC) == 0
    assert workers <= GN.CL_THREADS or workers == C // GN.VEC
    plan = GN.launch_plan((2, C, 4, 4), (16 * C, 1, 4 * C, C), 32, 132, LIMITS)
    assert plan[1] and plan[8] == workers
    assert plan[7] == -(-workers // 32) * 32 <= MAX_CL_THREADS


def _cl(x):
    return GN.channels_last(x.shape, x.stride())


def test_channels_last_test():
    x = torch.empty(2, 8, 3, 5)
    assert _cl(x.contiguous(memory_format=torch.channels_last))
    assert not _cl(x)
    assert not _cl(x[:, :, :, ::2].contiguous(memory_format=torch.channels_last)[:, :, :, :2])
    assert _cl(torch.empty(2, 8, 3, 4, 5).contiguous(memory_format=torch.channels_last_3d))
    assert _cl(torch.empty(2, 5, 8).transpose(1, 2))                     # [N, L, C] storage
    h = torch.empty(2, 3, 5, 8)                                           # [B, H, W, C]
    assert _cl(h.permute(0, 3, 1, 2) + torch.empty(2, 8, 3, 5))


@pytest.mark.parametrize("dims", [4, 5])
def test_launch_plan_reads_the_layout(dims):
    """Contiguous and channels-last inputs are launched in place, anything
    else is copied to contiguous first; the plan is the same for a layout
    whatever the call, and it is kept."""
    shape = (32, 320, 40, 72) if dims == 4 else (2, 320, 16, 40, 72)
    fmt = torch.channels_last if dims == 4 else torch.channels_last_3d
    x = torch.empty(shape, dtype=torch.bfloat16)
    cl = x.contiguous(memory_format=fmt)
    plan = lambda t, g=32: GN.launch_plan(t.shape, t.stride(), g, 132, LIMITS)
    assert plan(x)[:2] == (False, False) and plan(cl)[:2] == (False, True)
    assert plan(x)[7:] == (THREADS, THREADS)
    strided = x[..., ::2]
    assert plan(strided) == (True, False) + plan(strided.contiguous())[2:]
    assert plan(x)[2:5] == (shape[0], 320, x.numel() // (shape[0] * 320))
    assert plan(x) is plan(x.clone())
    wide = torch.empty((2, 8192) + (2,) * (dims - 2),
                       dtype=torch.bfloat16).contiguous(memory_format=fmt)
    assert plan(wide)[:2] == (True, False)           # C / 8 beyond the most threads: copied
    many = torch.empty((2, 4096) + (2,) * (dims - 2),
                       dtype=torch.bfloat16).contiguous(memory_format=fmt)
    assert plan(many, g=2048)[:2] == (False, True)   # any group count is read in place


_PLAIN = GN._plain


def _calls(model, call, want, monkeypatch):
    """`call` routes every one of `model`'s GroupNorms through the wrapper:
    `want` calls of the plain form (the CPU's route) and no kernel launch,
    and the state dict's GroupNorm keys are each module's weight and bias."""
    names = [n for n, m in model.named_modules() if isinstance(m, nn.GroupNorm)]
    keys = set(model.state_dict())
    assert all(f"{n}.weight" in keys and f"{n}.bias" in keys for n in names)
    plain = []
    monkeypatch.setattr(GN, "_plain", lambda *a: plain.append(a) or _PLAIN(*a))
    reset_launches(GN.group_norm)
    with torch.inference_mode():
        call()
    assert len(plain) == want and GN.group_norm.route_launches == {"split": 0}
    return len(names), len(keys)


def test_models_norms_go_through_the_wrapper(monkeypatch):
    torch.manual_seed(2)
    m2 = unet2d.UNet2DConditionModel(unet2d.unet_tiny())
    assert _calls(m2, lambda: m2(torch.randn(2, 16, 16, 4), torch.tensor([10, 500]),
                                 torch.randn(2, 7, 32)), 24, monkeypatch) == (24, 286)
    m3 = unet3d.UNet3DConditionModel(unet3d.unet3d_tiny())
    assert _calls(m3, lambda: m3(torch.randn(1, 3, 16, 16, 4), torch.tensor([10]),
                                 torch.randn(1, 7, 32)), 64, monkeypatch) == (64, 622)
    ae = vae.AutoencoderKL(vae.vae_tiny())
    assert _calls(ae, lambda: ae.decode(ae.encode(torch.randn(1, 16, 16, 3))), 24,
                  monkeypatch) == (24, 124)


@pytest.mark.parametrize("param_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("silu", [True, False])
def test_kernel_route_gradient_is_the_plain_forms(monkeypatch, param_dtype, silu):
    """Where a gradient is needed the kernel runs through GroupNormFunction:
    its forward is the kernel's (here a CPU stand-in that is the plain form
    with the parameters the kernel reads, bf16), its backward autograd
    through the plain form, so x, weight and bias get the plain form's
    gradients, weights of another dtype included."""
    launched = []

    def kernel(x, groups, weight, bias, eps, silu):
        launched.append(x.shape)
        w, b = (GN._param(p, n, x) for p, n in ((weight, "weight"), (bias, "bias")))
        return GN._plain(x, groups, w, b, eps, silu)

    monkeypatch.setattr(GN, "group_norm_kernel",
                        lambda x, g, w, b, eps, silu=False: kernel(x, g, w, b, eps, silu))
    monkeypatch.setattr(GN, "kernel_takes", lambda x: True)
    torch.manual_seed(3)
    x0 = torch.randn(2, 8, 5, 3, dtype=torch.bfloat16)
    norm = nn.GroupNorm(4, 8, eps=1e-6, dtype=param_dtype)
    with torch.no_grad():
        norm.weight.normal_(1, 0.3)
        norm.bias.normal_(0, 0.3)
    up = torch.randn(2, 8, 5, 3, dtype=torch.bfloat16)

    def grads(fn):
        x = x0.clone().requires_grad_()
        norm.zero_grad()
        (fn(x) * up).float().sum().backward()
        return x.grad, norm.weight.grad, norm.bias.grad

    got = grads(lambda x: GN.group_norm(x, norm, silu=silu))
    assert launched == [x0.shape]
    want = grads(lambda x: GN._plain(x, 4, norm.weight.to(torch.bfloat16),
                                     norm.bias.to(torch.bfloat16), 1e-6, silu))
    for g, h in zip(got, want):
        assert g.dtype == h.dtype and torch.equal(g, h)
    with torch.no_grad():                             # no gradient: the kernel directly
        GN.group_norm(x0, norm, silu=silu)
    assert len(launched) == 2
