"""The flash-attention CUDA kernel against its plain PyTorch version.

These tests need an NVIDIA GPU: the kernel has no CPU mode, so without a
card they skip. They import torch only, so they also run where JAX is not
installed: ``python -m pytest --noconftest tests/test_torch_flash_cuda.py``.

Tolerances: bf16 q/k/v give the same bf16 operands to both versions; they
differ in summation order, in the kernel rounding P to bf16 before P.V (as
the TPU kernel does) and in the bf16 rounding of the output, so out is held
to 2e-2 and the fp32 lse to 1e-3. fp32 inputs are rounded to bf16 for the
kernel's tensor cores, so there both are held to 3e-2.
"""

import numpy as np
import pytest
import torch

from spider_tpu_torch.ops import attention as A

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, T, S, Hq, Hkv, D, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(dev, dtype)
    return mk(B, T, Hq, D), mk(B, S, Hkv, D), mk(B, S, Hkv, D)


def _check(q, k, v, atol_out, atol_lse, **kw):
    before = A.flash_attention.launches
    out, lse = A.flash_attention_with_lse(q, k, v, **kw)
    torch.cuda.synchronize()
    assert A.flash_attention.launches == before + 1
    want, want_lse = A.mha_reference_with_lse(q, k, v, **kw)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert lse.shape == (q.shape[0], q.shape[2], q.shape[1]) and lse.dtype == torch.float32
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    err = (out.float() - want.float()).abs().max().item()
    err_lse = (lse - want_lse).abs().max().item()
    assert err <= atol_out, err
    assert err_lse <= atol_lse, err_lse


@pytest.mark.parametrize("D", [40, 64, 80, 128])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_kernel_matches_plain_bf16(dev, D, group, causal):
    # T and S not multiples of the 64-row tiles: the kernel masks the edges.
    q, k, v = _inputs(2, 100, 100, 2 * group, 2, D, torch.bfloat16, dev)
    _check(q, k, v, 2e-2, 1e-3, causal=causal)


@pytest.mark.parametrize("conv", ["suffix", "kv_len", "q_offset"])
def test_kernel_position_conventions(dev, conv):
    B, T, S = 2, 70, 150
    q, k, v = _inputs(B, T, S, 8, 2, 128, torch.bfloat16, dev, seed=1)
    kw = dict(causal=True)
    if conv in ("kv_len", "q_offset"):
        kw["kv_len"] = torch.tensor([90, 150], dtype=torch.int32, device=dev)
    if conv == "q_offset":
        kw["q_offset"] = torch.tensor([20, 80], dtype=torch.int32, device=dev)
    _check(q, k, v, 2e-2, 1e-3, **kw)


def test_kernel_prefill_shape(dev):
    # The 8B prefill: the whole cache S = T + 150, kv_len = T, q_offset = 0.
    T = 300
    q, k, v = _inputs(1, T, T + 150, 32, 8, 128, torch.bfloat16, dev, seed=2)
    _check(q, k, v, 2e-2, 1e-3, causal=True,
           kv_len=torch.tensor([T], dtype=torch.int32, device=dev), q_offset=0)


def test_kernel_unet_cross_attention_shape(dev):
    # SD level-0 cross-attention: D = 40 and 77 text keys, non-causal.
    q, k, v = _inputs(2, 4096, 77, 8, 8, 40, torch.bfloat16, dev, seed=3)
    _check(q, k, v, 2e-2, 1e-3, causal=False)


@pytest.mark.parametrize("T,S", [(300, 300), (500, 1)])
def test_kernel_audioldm_shapes(dev, T, S):
    # AudioLDM level 0: D = 16; its cross-attention has one key (the CLAP vector).
    q, k, v = _inputs(2, T, S, 8, 8, 16, torch.bfloat16, dev, seed=5)
    _check(q, k, v, 2e-2, 1e-3, causal=False)


def test_kernel_fp32_inputs(dev):
    q, k, v = _inputs(1, 130, 130, 4, 2, 64, torch.float32, dev, seed=4)
    _check(q, k, v, 3e-2, 3e-2, causal=True)


def test_kernel_rejects_what_it_does_not_take(dev):
    q, k, v = _inputs(1, 16, 16, 2, 2, 64, torch.float16, dev)
    with pytest.raises(TypeError):
        A.flash_attention(q, k, v)
    q, k, v = _inputs(1, 16, 16, 2, 2, 160, torch.bfloat16, dev)
    with pytest.raises(ValueError):
        A.flash_attention(q, k, v)
    q, k, v = _inputs(1, 16, 16, 2, 2, 64, torch.bfloat16, dev)
    with pytest.raises(ValueError):
        A.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
