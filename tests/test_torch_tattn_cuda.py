"""The temporal-attention CUDA kernel against its plain PyTorch version.

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


def _check(q, k, v, heads, layout, atol, rtol=BF16_EPS):
    before = TA.temporal_attention.launches
    out = TA.temporal_attention_kernel(q, k, v, heads, layout=layout)
    torch.cuda.synchronize()
    assert TA.temporal_attention.launches == before + 1
    want = TA.temporal_attention_reference(q, k, v, heads, layout=layout)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert torch.isfinite(out).all()
    excess = (out.float() - want.float()).abs() - (atol + rtol * want.float().abs())
    assert excess.max().item() <= 0, (out.float() - want.float()).abs().max().item()


@pytest.mark.parametrize("layout", ["bfpc", "bpfc"])
@pytest.mark.parametrize("F", [6, 16])
@pytest.mark.parametrize("D", [40, 80, 160])
def test_kernel_matches_plain_bf16(dev, D, F, layout):
    # P = 45 is ragged against every pixel tile the kernel picks.
    B, P, H = 2, 45, 8
    shape = (B, P, F, H * D) if layout == "bpfc" else (B, F, P, H * D)
    _check(*_inputs(shape, torch.bfloat16, dev), H, layout, 2e-2)


@pytest.mark.parametrize("F,D,H", [(1, 8, 2), (32, 64, 4), (20, 256, 1)])
def test_kernel_frame_and_head_dim_edges(dev, F, D, H):
    _check(*_inputs((1, F, 33, H * D), torch.bfloat16, dev, seed=1), H, "bfpc", 2e-2)


def test_kernel_zeroscope_level0(dev):
    _check(*_inputs((2, 16, 2880, 320), torch.bfloat16, dev, seed=2), 8, "bfpc", 2e-2)


@pytest.mark.parametrize("layout", ["bfpc", "bpfc"])
def test_kernel_fp32_inputs(dev, layout):
    shape = (2, 70, 16, 640) if layout == "bpfc" else (2, 16, 70, 640)
    _check(*_inputs(shape, torch.float32, dev, seed=3), 8, layout, 1e-4, rtol=0.0)


def test_kernel_reads_strided_views(dev):
    # Channel slices of wider tensors: the kernel reads the strides it is given.
    wide = _inputs((2, 16, 40, 1280), torch.bfloat16, dev, seed=4)
    q, k, v = (x[..., 320:960] for x in wide)
    assert not q.is_contiguous()
    _check(q, k, v, 8, "bfpc", 2e-2)


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
