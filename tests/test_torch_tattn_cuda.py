"""The temporal-attention CUDA kernels against their plain PyTorch version.

Every bf16 case runs both forms (``ops/temporal_attention.py::tattn_route``),
each named by the call: "ring", the persistent form with asynchronous
staging that the rule sends bf16 to, and "simple", the first form, which fp32
inputs take.

These tests need an NVIDIA GPU: the kernel has no CPU mode, so without a
card they skip. They import torch only, so they also run where JAX is not
installed: ``python -m pytest --noconftest tests/test_torch_tattn_cuda.py``.

Tolerances: with bf16 q/k/v both versions take the same bf16 operands,
keep the logits in fp32 and round the probabilities to bf16 before
probs . v; they differ in summation order, and both round the output to
bf16. So outputs are held to 2e-2 plus bf16's unit roundoff (2^-8) times
|plain|: with 16 frames an output can pass 4, where one bf16 step is
0.03125. With fp32 inputs both compute in fp32 (TF32 off), so 1e-4.
"""

import numpy as np
import pytest
import torch

from spider_tpu_torch.ops import temporal_attention as TA

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the temporal kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, dtype)
                 for _ in range(3))


BF16_EPS = 2.0 ** -8


ROUTES = pytest.mark.parametrize("route", ["ring", "simple"])


def _check(q, k, v, heads, layout, atol, rtol=BF16_EPS, route=None):
    before = TA.temporal_attention.launches, dict(TA.temporal_attention.route_launches)
    out = TA.temporal_attention_kernel(q, k, v, heads, layout=layout, route=route)
    torch.cuda.synchronize()
    took = route or TA.tattn_route(q.dtype)
    assert TA.temporal_attention.launches == before[0] + 1
    assert TA.temporal_attention.route_launches == {r: n + (r == took)
                                                    for r, n in before[1].items()}
    want = TA.temporal_attention_reference(q, k, v, heads, layout=layout)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert torch.isfinite(out).all()
    excess = (out.float() - want.float()).abs() - (atol + rtol * want.float().abs())
    assert excess.max().item() <= 0, (out.float() - want.float()).abs().max().item()


@pytest.mark.parametrize("layout", ["bfpc", "bpfc"])
@pytest.mark.parametrize("F", [6, 16])
@pytest.mark.parametrize("D", [40, 80, 160])
@ROUTES
def test_kernel_matches_plain_bf16(dev, D, F, layout, route):
    # P = 45 is ragged against every pixel tile the kernels pick.
    B, P, H = 2, 45, 8
    shape = (B, P, F, H * D) if layout == "bpfc" else (B, F, P, H * D)
    _check(*_inputs(shape, torch.bfloat16, dev), H, layout, 2e-2, route=route)


@pytest.mark.parametrize("F,D,H", [(1, 8, 2), (8, 40, 8), (12, 64, 8), (32, 64, 4),
                                   (32, 40, 8), (20, 256, 1)])
@ROUTES
def test_kernel_frame_and_head_dim_edges(dev, F, D, H, route):
    _check(*_inputs((1, F, 33, H * D), torch.bfloat16, dev, seed=1), H, "bfpc", 2e-2,
           route=route)


# ZeroScope's four levels at CFG batch 2, 16 frames, 8 heads: (P, C).
LEVELS = {"L0": (2880, 320), "L1": (720, 640), "L2": (180, 1280), "mid": (45, 1280)}


@pytest.mark.parametrize("level", list(LEVELS))
@ROUTES
def test_kernel_zeroscope_levels(dev, level, route):
    P, C = LEVELS[level]
    _check(*_inputs((2, 16, P, C), torch.bfloat16, dev, seed=2), 8, "bfpc", 2e-2, route=route)


@pytest.mark.parametrize("level", list(LEVELS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["ring", "simple"])
def test_gradients_through_the_kernel_match_plain(dev, level, dtype):
    # temporal_attention on CUDA tensors inside the predicate is
    # differentiable: the kernel's forward ("ring" for bf16, "simple" for
    # fp32), the plain form's gradient, and no kernel in the backward.
    P, C = LEVELS[level]
    q, k, v = _inputs((2, 16, P, C), dtype, dev, seed=8)
    dout = _inputs((2, 16, P, C), dtype, dev, seed=9)[0]
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = TA.temporal_attention.launches, dict(TA.temporal_attention.route_launches)
    out = TA.temporal_attention(*leaves, 8)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    took = TA.tattn_route(dtype)
    assert TA.temporal_attention.launches == before[0] + 1
    assert TA.temporal_attention.route_launches == {r: n + (r == took)
                                                    for r, n in before[1].items()}
    plain = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(TA.temporal_attention_reference(*plain, 8), plain, dout)
    atol, rtol = (2e-2, BF16_EPS) if dtype == torch.bfloat16 else (1e-4, 0.0)
    for got, exp in zip(grads, want):
        assert got.dtype == dtype and torch.isfinite(got).all()
        excess = (got.float() - exp.float()).abs() - (atol + rtol * exp.float().abs())
        assert excess.max().item() <= 0


@pytest.mark.parametrize("P", [1001, 33, 1])
@pytest.mark.parametrize("layout", ["bfpc", "bpfc"])
@ROUTES
def test_kernel_ragged_pixel_counts(dev, P, layout, route):
    # pixels past P are neither read into the result nor written
    shape = (2, P, 16, 640) if layout == "bpfc" else (2, 16, P, 640)
    _check(*_inputs(shape, torch.bfloat16, dev, seed=6), 8, layout, 2e-2, route=route)


def test_ring_gives_the_same_bits_twice(dev):
    # one warp owns a (pixel, head) unit and sums in a fixed order
    q, k, v = _inputs((2, 16, 101, 320), torch.bfloat16, dev, seed=7)
    first = TA.temporal_attention_kernel(q, k, v, 8, route="ring")
    again = TA.temporal_attention_kernel(q, k, v, 8, route="ring")
    torch.cuda.synchronize()
    assert torch.equal(first, again)


@pytest.mark.parametrize("layout", ["bfpc", "bpfc"])
@pytest.mark.parametrize("route", [None, "simple"])
def test_kernel_fp32_inputs(dev, layout, route):
    # fp32 is the simple form's alone, by the rule and by name
    shape = (2, 70, 16, 640) if layout == "bpfc" else (2, 16, 70, 640)
    q, k, v = _inputs(shape, torch.float32, dev, seed=3)
    assert TA.tattn_route(q.dtype) == "simple"
    _check(q, k, v, 8, layout, 1e-4, rtol=0.0, route=route)


@ROUTES
def test_kernel_reads_strided_views(dev, route):
    # Channel slices of wider tensors: the kernels read the strides they are given.
    wide = _inputs((2, 16, 40, 1280), torch.bfloat16, dev, seed=4)
    q, k, v = (x[..., 320:960] for x in wide)
    assert not q.is_contiguous()
    _check(q, k, v, 8, "bfpc", 2e-2, route=route)


def test_wrapper_routes_like_the_reference(dev):
    q, k, v = _inputs((2, 16, 64, 320), torch.bfloat16, dev, seed=5)
    before = TA.temporal_attention.launches
    out = TA.temporal_attention(q, k, v, 8)               # H*F = 128, P = 64: the kernel
    assert TA.temporal_attention.launches == before + 1
    with TA.temporal_attention_config("plain"):
        plain = TA.temporal_attention(q, k, v, 8)
    assert TA.temporal_attention.launches == before + 1
    excess = (out.float() - plain.float()).abs() - (2e-2 + BF16_EPS * plain.float().abs())
    assert excess.max().item() <= 0
    small = tuple(x[:, :, :16] for x in (q, k, v))        # P = 16 < 32: plain
    TA.temporal_attention(*small, 8)
    assert TA.temporal_attention.launches == before + 1


def test_kernel_rejects_what_it_does_not_take(dev):
    q, k, v = _inputs((1, 16, 40, 320), torch.float16, dev)
    with pytest.raises(TypeError):
        TA.temporal_attention(q, k, v, 8)                 # inside the predicate: no fallback
    q, k, v = _inputs((1, 16, 40, 320), torch.float32, dev)
    before = TA.temporal_attention.launches
    with pytest.raises(ValueError):
        TA.temporal_attention_kernel(q, k, v, 8, route="ring")   # fp32: no fallback
    assert TA.temporal_attention.launches == before
    q, k, v = _inputs((1, 16, 40, 96), torch.bfloat16, dev)
    with pytest.raises(ValueError):
        TA.temporal_attention_kernel(q, k, v, 8)          # D = 12
    q, k, v = _inputs((1, 33, 40, 64), torch.bfloat16, dev)
    with pytest.raises(ValueError):
        TA.temporal_attention_kernel(q, k, v, 8)          # F = 33
    q, k, v = _inputs((1, 16, 40, 320), torch.bfloat16, dev)
    with pytest.raises(ValueError):
        TA.temporal_attention_kernel(q, k.transpose(1, 2).contiguous().transpose(1, 2), v, 8)
    flat = torch.zeros(1 + 16 * 40 * 320, dtype=torch.bfloat16, device=dev)
    shifted = flat[1:].view(1, 16, 40, 320)               # 2-byte offset
    with pytest.raises(ValueError):
        TA.temporal_attention_kernel(shifted, shifted, shifted, 8)
