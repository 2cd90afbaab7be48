"""The paged decode-attention CUDA kernel against its plain PyTorch version.

These tests need an NVIDIA GPU: the kernel has no CPU mode, so without a
card they skip. They import torch only, so they also run where JAX is not
installed: ``python -m pytest --noconftest tests/test_torch_paged_cuda.py``.

Tolerances: bf16 inputs give the same bf16 operands to both versions; they
differ in summation order and in where sm_scale is applied (the kernel
scales q, the plain version the logits), and both round the output to
bf16, where one step is 2^-6 for |out| in [2, 4): out is held to 2e-2. In
fp32 only the summation order differs: 1e-4.
"""

import numpy as np
import pytest
import torch

from spider_tpu_torch.ops import paged_attention as P

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the paged decode kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, Hq, Hkv, D, page, MP, n_blocks, kv_len, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(dev, dtype)
    q = mk(B, Hq, D)
    pool_k, pool_v = mk(n_blocks, page, Hkv, D), mk(n_blocks, page, Hkv, D)
    table = torch.from_numpy(rng.permutation(n_blocks)[: B * MP].reshape(B, MP)
                             .astype(np.int32)).to(dev)
    lens = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    return q, pool_k, pool_v, table, lens


def _check(args, atol):
    before = P.paged_decode_attention.launches
    out = P.paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert P.paged_decode_attention.launches == before + 1
    want = P.paged_decode_reference(*args)
    q = args[0]
    assert out.shape == q.shape and out.dtype == q.dtype
    assert torch.isfinite(out).all()
    err = (out.float() - want.float()).abs().max().item()
    assert err <= atol, err


def test_serving_shapes(dev):
    # The 8B decoder at 16 slots, page 128, max_len 512: kv_len at and around
    # page edges, a full window, and one past the table (the walk
    # must stop after max_pages pages).
    MP, page = 4, 128
    lens = [1, 127, 128, 129, 512, MP * page + 5, 300, 2, 255, 256, 257, 384, 511, 64, 65, 400]
    args = _inputs(16, 32, 8, 128, page, MP, 80, lens, torch.bfloat16, dev)
    _check(args, 2e-2)


def test_long_context_one_slot(dev):
    # The chat's long context: one slot, 14 pages, kv_len 1758.
    args = _inputs(1, 32, 8, 128, 128, 14, 20, [1758], torch.bfloat16, dev, seed=1)
    _check(args, 2e-2)


@pytest.mark.parametrize("D", [8, 40, 64, 256])
@pytest.mark.parametrize("group", [1, 4])
def test_head_dims_and_groups(dev, D, group):
    args = _inputs(3, 2 * group, 2, D, 16, 5, 20, [1, 33, 80], torch.bfloat16, dev, seed=2)
    _check(args, 2e-2)


@pytest.mark.parametrize("page", [7, 48])
def test_pages_that_are_not_tile_multiples(dev, page):
    # Tiles of 32 keys straddle pages of 7 and 48 rows.
    args = _inputs(4, 8, 2, 64, page, 6, 30, [1, page, 3 * page + 1, 6 * page], torch.bfloat16,
                   dev, seed=3)
    _check(args, 2e-2)


def test_fp32_pools(dev):
    args = _inputs(4, 8, 2, 64, 16, 4, 20, [5, 16, 40, 64], torch.float32, dev, seed=4)
    _check(args, 1e-4)


def test_empty_slot_is_zero(dev):
    # kv_len = 0: the kernel gives 0, as the TPU kernel does (the plain
    # gather route gives the mean of V there, so it is not compared).
    q, pk, pv, table, _ = _inputs(2, 8, 2, 64, 16, 4, 10, [0, 0], torch.bfloat16, dev, seed=5)
    lens = torch.tensor([0, 20], dtype=torch.int32, device=dev)
    out = P.paged_decode_attention(q, pk, pv, table, lens)
    want = P.paged_decode_reference(q, pk, pv, table, lens)
    torch.cuda.synchronize()
    assert (out[0] == 0).all()
    assert (out[1].float() - want[1].float()).abs().max().item() <= 2e-2


def test_kernel_rejects_what_it_does_not_take(dev):
    q, pk, pv, table, lens = _inputs(2, 8, 2, 64, 16, 4, 10, [5, 9], torch.float16, dev)
    with pytest.raises(TypeError):
        P.paged_decode_attention(q, pk, pv, table, lens)
    q, pk, pv, table, lens = _inputs(2, 8, 2, 64, 16, 4, 10, [5, 9], torch.bfloat16, dev)
    with pytest.raises(TypeError):
        P.paged_decode_attention(q.float(), pk, pv, table, lens)
    with pytest.raises(ValueError):
        P.paged_decode_attention(q.transpose(0, 1).contiguous().transpose(0, 1), pk, pv,
                                 table, lens)
    with pytest.raises(ValueError):
        P.paged_decode_attention(q, pk.transpose(0, 1).contiguous().transpose(0, 1), pv,
                                 table, lens)
    for D in (12, 264):
        q, pk, pv, table, lens = _inputs(2, 8, 2, D, 16, 4, 10, [5, 9], torch.bfloat16, dev)
        with pytest.raises(ValueError):
            P.paged_decode_attention(q, pk, pv, table, lens)
