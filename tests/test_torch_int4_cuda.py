"""The int4 weight-only matmul CUDA kernel against its plain PyTorch version.

These tests need an NVIDIA GPU: the kernel has no CPU mode, so without a
card they skip. They import torch only, so they also run where JAX is not
installed: ``python -m pytest --noconftest tests/test_torch_int4_cuda.py``.

Inputs: x ~ N(0, 1), int4 weights uniform in [-8, 7], scale
1 / (4.61 sqrt(K)) so the outputs are O(1). Tolerances: the nibbles and
bf16 x are exact in both versions and the products accumulate in fp32, so
they differ only in summation order (~1e-6 here) and in the final bf16
rounding of the output, half a step or 2^-9 |out|, plus one step where the
two sums fall on either side of a rounding edge: bf16 out is held to
1e-3 + 2^-7 |plain|. fp32 out with bf16 x: 1e-4. fp32 x goes through the
tensor cores as a pair of bf16 (about 16 bits of mantissa): 1e-4.

Every bf16 case runs on the route ``int4_route`` names ("stream" up to 16
rows with K/2 up to 2048, "wgmma" from 48 rows, the first kernel "mma"
between, for a longer K at up to 16 rows, for fp32 x and for a K/2 that is no
multiple of 16) and on "mma"; the two new routes are run several times and
must give the same bits.
"""

import numpy as np
import pytest
import torch

from spider_tpu_torch.ops import quant as Q

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the int4 kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(M, K, N, x_dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((M, K), dtype=np.float32)).to(dev, x_dtype)
    w = torch.from_numpy(rng.integers(-8, 8, size=(K, N)).astype(np.int8))
    packed = Q.pack_int4(w).t().contiguous().to(dev)              # the port's [N, K/2]
    scale = torch.from_numpy((rng.uniform(0.5, 1.5, N) / (4.61 * K ** 0.5))
                             .astype(np.float32)).to(dev)
    return x, packed, scale


def _ruled(x, packed):
    M = x.numel() // x.shape[-1]
    aligned = (x.data_ptr() | packed.data_ptr()) % 16 == 0
    return Q.int4_route(x.dtype, M, packed.shape[1], aligned)


def _check(x, packed, scale, out_dtype, route=None):
    """One launch through `route` ("ruled": the rule's, through int4_matmul)
    held to the plain version; returns the output."""
    ruled = _ruled(x, packed)
    before = (Q.int4_matmul.launches, Q.int4_matmul.route_launches[ruled if route in
                                                                   (None, "ruled") else route])
    if route in (None, "ruled"):
        out = Q.int4_matmul(x, packed, scale, out_dtype)
        route = ruled
    else:
        out = Q.int4_matmul_kernel(x, packed, scale, out_dtype, route=route)
    torch.cuda.synchronize()
    assert (Q.int4_matmul.launches, Q.int4_matmul.route_launches[route]) == (before[0] + 1,
                                                                            before[1] + 1)
    want = Q.int4_matmul_reference(x, packed, scale, out_dtype)
    assert out.shape == want.shape and out.dtype == want.dtype == out_dtype
    assert torch.isfinite(out).all()
    diff = (out.float() - want.float()).abs()
    if out_dtype == torch.bfloat16:
        bound = 1e-3 + 2.0 ** -7 * want.float().abs()
    else:
        bound = torch.full_like(diff, 1e-4)
    assert (diff <= bound).all(), diff.max().item()
    return out


@pytest.mark.parametrize("route", ["ruled", "mma"])
@pytest.mark.parametrize("M", [1, 16, 128, 1024])
@pytest.mark.parametrize("K,N", [(4096, 1024), (14336, 512), (512, 4096)])
def test_kernel_matches_plain_bf16(dev, M, K, N, route):
    _check(*_inputs(M, K, N, torch.bfloat16, dev, seed=M), torch.bfloat16, route)


@pytest.mark.parametrize("M,want", [(1, "stream"), (16, "stream"), (17, "mma"), (47, "mma"),
                                    (48, "wgmma"), (128, "wgmma"), (1024, "wgmma")])
def test_the_rule_picks_the_route(dev, M, want):
    x, packed, scale = _inputs(M, 512, 64, torch.bfloat16, dev, seed=6)
    assert _ruled(x, packed) == want
    _check(x, packed, scale, torch.bfloat16)


@pytest.mark.parametrize("M", [1, 5, 16, 17, 48, 63, 65, 128, 129, 1000])
@pytest.mark.parametrize("K,N", [
    (4096, 1000),     # N no multiple of a 16- or 128-column tile
    (4096, 136),      # one column tile and a sliver
    (14336, 272),     # K/2 = 7168: "mma" up to 16 rows; four K slices of the wgmma form
    (4128, 1000),     # K/2 = 2064: just over the stream form's rows; a ragged k tile
    (4064, 1000),     # K/2 = 2032: the stream form's last warp has 112 of its 128 bytes
    (96, 4096),       # K/2 = 48: less than one k tile
])
def test_tile_and_slice_edges(dev, M, K, N):
    _check(*_inputs(M, K, N, torch.bfloat16, dev, seed=M + K), torch.bfloat16)


@pytest.mark.parametrize("M,K,N", [(1, 4096, 4096), (16, 4096, 14336), (5, 4096, 1024),
                                   (7, 4064, 1000), (128, 14336, 4096), (256, 4096, 1024),
                                   (1000, 4096, 1000), (64, 14336, 272)])
def test_new_routes_give_the_same_bits_twice(dev, M, K, N):
    # Partial sums meet in a fixed order (warps of a block; K slices of the wgmma
    # form through scratch; no atomics on floats): run the rule's route several
    # times, with other work between, and compare the bits.
    x, packed, scale = _inputs(M, K, N, torch.bfloat16, dev, seed=7)
    assert _ruled(x, packed) in ("stream", "wgmma")
    first = _check(x, packed, scale, torch.bfloat16)
    for _ in range(5):
        _check(*_inputs(16, 4096, 1024, torch.bfloat16, dev, seed=8), torch.bfloat16)
        again = Q.int4_matmul(x, packed, scale, torch.bfloat16)
        torch.cuda.synchronize()
        assert torch.equal(first, again)


@pytest.mark.parametrize("route,M,K,dtype", [("stream", 128, 512, torch.bfloat16),
                                             ("wgmma", 16, 512, torch.bfloat16),
                                             ("stream", 16, 512, torch.float32),
                                             ("wgmma", 32, 512, torch.bfloat16),
                                             ("stream", 16, 4128, torch.bfloat16)])
def test_a_named_route_raises_on_what_the_rule_does_not_send_it(dev, route, M, K, dtype):
    x, packed, scale = _inputs(M, K, 64, dtype, dev)
    before = (Q.int4_matmul.launches, dict(Q.int4_matmul.route_launches))
    with pytest.raises(ValueError):
        Q.int4_matmul_kernel(x, packed, scale, route=route)
    assert (Q.int4_matmul.launches, Q.int4_matmul.route_launches) == before


def test_an_unaligned_x_takes_the_first_kernel(dev):
    x, packed, scale = _inputs(17, 512, 64, torch.bfloat16, dev, seed=9)
    shifted = x.flatten()[8:8 + 16 * 512].view(16, 512)      # 16 bytes on, still aligned
    assert _ruled(shifted, packed) == "stream"
    odd = x.flatten()[4:4 + 16 * 512].view(16, 512)          # 8 bytes on
    assert _ruled(odd, packed) == "mma"
    _check(odd, packed, scale, torch.bfloat16)


@pytest.mark.parametrize("M,K,N", [(37, 4100, 1000), (5, 34, 9), (17, 96, 33)])
def test_ragged_edges(dev, M, K, N):
    # K/2 not a multiple of 16 (scalar loads; the first kernel by the rule), N
    # and M not multiples of the block's 32 columns and 16 rows.
    _check(*_inputs(M, K, N, torch.bfloat16, dev, seed=1), torch.bfloat16)


def test_leading_dims_and_fp32_output(dev):
    x, packed, scale = _inputs(16, 1024, 256, torch.bfloat16, dev, seed=2)
    _check(x.reshape(2, 8, 1024), packed, scale, torch.float32)


def test_fp32_inputs(dev):
    _check(*_inputs(16, 2048, 512, torch.float32, dev, seed=3), torch.float32)
    _check(*_inputs(3, 66, 40, torch.float32, dev, seed=4), torch.bfloat16)


def test_long_inputs_take_the_reference_routing(dev):
    # M > 1024 rows: the JAX wrapper's own rule dequantises and calls the
    # library product, so no kernel launch. Dequantised weights are exact in
    # bf16; the product rounds to bf16 before the bf16 scale multiply: two
    # roundings of 2^-9 each.
    x, packed, scale = _inputs(1025, 512, 256, torch.bfloat16, dev, seed=5)
    before = Q.int4_matmul.launches
    out = Q.int4_matmul(x, packed, scale, torch.bfloat16)
    torch.cuda.synchronize()
    assert Q.int4_matmul.launches == before
    want = Q.int4_matmul_reference(x, packed, scale, torch.bfloat16)
    diff = (out.float() - want.float()).abs()
    assert (diff <= 1e-3 + 2.0 ** -6 * want.float().abs()).all(), diff.max().item()


def test_kernel_rejects_what_it_does_not_take(dev):
    x, packed, scale = _inputs(4, 64, 32, torch.bfloat16, dev)
    with pytest.raises(TypeError):
        Q.int4_matmul(x.half(), packed, scale)
    with pytest.raises(TypeError):
        Q.int4_matmul(x, packed.to(torch.uint8), scale)
    with pytest.raises(TypeError):
        Q.int4_matmul(x, packed, scale[:-1])
    with pytest.raises(ValueError):
        Q.int4_matmul(x[:, :32], packed, scale)
    with pytest.raises(ValueError):
        Q.int4_matmul(x.t().contiguous().t(), packed, scale)
    wide = torch.zeros(32, 64, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):
        Q.int4_matmul(x, wide[:, :32], scale)


# Qwen2-7B's projections (K in, N out): q/o, k/v, gate/up at hidden 3584, and
# down from 18944 (K/2 = 9472 > 2048: the first kernel at up to 16 rows).
QWEN2_SHAPES = [(3584, 3584), (3584, 512), (3584, 18944), (18944, 3584)]


@pytest.mark.parametrize("M", [1, 16, 128])
@pytest.mark.parametrize("K,N", QWEN2_SHAPES)
def test_qwen2_shapes(dev, M, K, N):
    x, packed, scale = _inputs(M, K, N, torch.bfloat16, dev, seed=M + N)
    want = "mma" if M <= 16 and K == 18944 else "stream" if M <= 16 else "wgmma"
    assert _ruled(x, packed) == want
    first = _check(x, packed, scale, torch.bfloat16)
    again = Q.int4_matmul(x, packed, scale, torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
