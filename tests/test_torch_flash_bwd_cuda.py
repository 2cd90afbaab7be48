"""The flash-attention backward CUDA kernels (dq; dk/dv) against their plain
PyTorch version, ``flash_backward_reference``.

These tests need an NVIDIA GPU: the kernels have no CPU mode, so without a
card they skip. They import torch only, so they also run where JAX is not
installed: ``python -m pytest --noconftest tests/test_torch_flash_bwd_cuda.py``.

Every bf16 case runs the dq and the dk/dv kernel of both routes, "wgmma" and
the general "mma" (``ops/attention.py::flash_route``), each named by the call.

Both versions take the same q, k, v, dO, out and lse (the forward kernel's).
Tolerances: with bf16 inputs they differ in the kernels rounding P and dS to
bf16 for the second products, in summation order and in the bf16 rounding of
the gradients (half a step is 2^-9 relative), so each gradient is held to
2e-2 + 2^-7 |plain| elementwise. fp32 inputs are rounded to bf16 for the
tensor cores, which moves the logits by ~2^-8 relative before the exp, so
there the bound is 3e-2 + 2^-5 |plain|.
"""

import numpy as np
import pytest
import torch

from spider_tpu_torch.ops import attention as A

pytestmark = pytest.mark.cuda
ROUTES = pytest.mark.parametrize("route", ["wgmma", "mma"])


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash backward kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, T, S, Hq, Hkv, D, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(dev, dtype)
    return mk(B, T, Hq, D), mk(B, S, Hkv, D), mk(B, S, Hkv, D), mk(B, T, Hq, D)


def _close(got, want, atol, rel, name):
    assert got.dtype == want.dtype and got.shape == want.shape, name
    assert torch.isfinite(got).all(), name
    excess = ((got.float() - want.float()).abs() - (atol + rel * want.float().abs())).max().item()
    assert excess <= 0, (name, excess)


def _check(q, k, v, g, atol=2e-2, rel=2.0 ** -7, g_lse=None, route=None, **kw):
    out, lse = A.flash_attention_with_lse(q, k, v, route=route, **kw)
    before = A.flash_bwd_dq.launches, A.flash_bwd_dkv.launches
    routed = dict(A.flash_bwd_dq.route_launches), dict(A.flash_bwd_dkv.route_launches)
    got = A.flash_backward(q, k, v, out, lse, g, g_lse=g_lse, route=route, **kw)
    torch.cuda.synchronize()
    assert (A.flash_bwd_dq.launches, A.flash_bwd_dkv.launches) == (before[0] + 1, before[1] + 1)
    took = route or A.flash_route(q.dtype, q.shape[-1])
    for fn, was in zip((A.flash_bwd_dq, A.flash_bwd_dkv), routed):
        assert fn.route_launches == {r: n + (r == took) for r, n in was.items()}
    want = A.flash_backward_reference(q, k, v, out, lse, g, g_lse=g_lse, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(a, b, atol, rel, name)
    assert want[0].float().abs().max() > 0


@pytest.mark.parametrize("D", [16, 40, 64, 80, 128])
@pytest.mark.parametrize("heads", [(4, 2), (8, 1), (2, 2)])
@pytest.mark.parametrize("causal", [False, True])
@ROUTES
def test_kernels_match_plain_bf16(dev, D, heads, causal, route):
    # T and S not multiples of the 64-row tiles: the kernels mask the edges.
    q, k, v, g = _inputs(2, 100, 100, *heads, D, torch.bfloat16, dev)
    _check(q, k, v, g, causal=causal, route=route)


# SAM ViT-H's mask decoder in the MASK train step (B 4, 8 heads): the 6
# prompt tokens' self-attention (D 32), token-to-image and image-to-token
# over the 64 x 64 grid (D 16): the first training launches at these head dims.
# With 6 keys a query (ROADMAP C6) each dk, dv row sums 4096 query rows: such
# a case is held to the plain form on fp32 inputs, the exact sum, by the same
# bound (the dk/dv kernels add the products of what rounding P and dS to bf16
# drops, without which they miss it there).
@pytest.mark.parametrize("T,S,D", [(6, 6, 32), (6, 4096, 16), (4096, 6, 16)])
@ROUTES
def test_kernels_match_plain_at_the_sam_decoder_shapes(dev, T, S, D, route):
    q, k, v, g = _inputs(4, T, S, 8, 8, D, torch.bfloat16, dev, seed=T + S)
    if S >= 40:
        _check(q, k, v, g, causal=False, route=route)
        return
    out, lse = A.flash_attention_with_lse(q, k, v, route=route, causal=False)
    got = A.flash_backward(q, k, v, out, lse, g, route=route, causal=False)
    want = A.flash_backward_reference(q.float(), k.float(), v.float(), out.float(), lse,
                                      g.float(), causal=False)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(a.float(), b, 2e-2, 2.0 ** -7, name)


@pytest.mark.parametrize("conv", ["suffix", "kv_len", "q_offset"])
@pytest.mark.parametrize("causal", [False, True])
@ROUTES
def test_kernels_position_conventions(dev, conv, causal, route):
    B, T, S = 2, 70, 150
    q, k, v, g = _inputs(B, T, S, 8, 2, 128, torch.bfloat16, dev, seed=1)
    kw = dict(causal=causal)
    if conv in ("kv_len", "q_offset"):
        kw["kv_len"] = torch.tensor([90, 150], dtype=torch.int32, device=dev)
    if conv == "q_offset":
        kw["q_offset"] = torch.tensor([20, 80], dtype=torch.int32, device=dev)
    _check(q, k, v, g, route=route, **kw)


@ROUTES
def test_kernels_more_queries_than_keys(dev, route):
    # kv_len-given causal with T > S rows below every key, and rows with no
    # live key at all (kv_len 0 for the second sample): zero gradient there.
    q, k, v, g = _inputs(2, 200, 90, 4, 2, 64, torch.bfloat16, dev, seed=6)
    kv_len = torch.tensor([90, 0], dtype=torch.int32, device=dev)
    _check(q, k, v, g, causal=True, kv_len=kv_len, route=route)
    out, lse = A.flash_attention_with_lse(q, k, v, causal=True, kv_len=kv_len, route=route)
    dq, dk, dv = A.flash_backward(q, k, v, out, lse, g, causal=True, kv_len=kv_len,
                                  route=route)
    assert not dq[1].any() and not dk[1].any() and not dv[1].any()


@ROUTES
def test_kernels_with_lse_cotangent(dev, route):
    q, k, v, g = _inputs(2, 130, 130, 8, 2, 64, torch.bfloat16, dev, seed=7)
    g_lse = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 8, 130), dtype=np.float32)).to(dev)
    _check(q, k, v, g, g_lse=g_lse, causal=True, route=route)


@pytest.mark.parametrize("shape", [(4, 512, 512, 32, 8, 128), (1, 2048, 2048, 32, 8, 128)])
@ROUTES
def test_kernels_full_width_shapes(dev, shape, route):
    # The training step of the 8B model (batch 4 x 512) and one long sequence.
    q, k, v, g = _inputs(*shape, torch.bfloat16, dev, seed=9)
    _check(q, k, v, g, causal=True, route=route)


@pytest.mark.parametrize("route", [None, "mma"])
def test_kernels_fp32_inputs(dev, route):
    # fp32 is the general route's alone, by the rule and by name.
    q, k, v, g = _inputs(1, 130, 130, 4, 2, 64, torch.float32, dev, seed=4)
    _check(q, k, v, g, atol=3e-2, rel=2.0 ** -5, causal=True, route=route)


def test_kernels_head_dim_off_the_tma_grid(dev):
    q, k, v, g = _inputs(2, 100, 100, 4, 2, 36, torch.bfloat16, dev, seed=5)
    assert A.flash_route(q.dtype, 36) == "mma"
    _check(q, k, v, g, causal=True)


# The wgmma kernels' tiles: dk/dv takes 128 keys a block (64 a warpgroup) and
# 64 query rows a tile, dq 128 query rows an item (64 a warpgroup) and 64
# keys a tile. One below, at and one above 128 and 256.
EDGES = [127, 128, 129, 255, 256, 257]


@pytest.mark.parametrize("S", EDGES)
@pytest.mark.parametrize("causal", [False, True])
@ROUTES
def test_kernels_key_tile_edges(dev, S, causal, route):
    q, k, v, g = _inputs(2, 70, S, 8, 2, 128, torch.bfloat16, dev, seed=21)
    _check(q, k, v, g, causal=causal, route=route)


@pytest.mark.parametrize("T", EDGES)
@pytest.mark.parametrize("causal", [False, True])
@ROUTES
def test_kernels_query_tile_edges(dev, T, causal, route):
    q, k, v, g = _inputs(1, T, 200, 4, 2, 64, torch.bfloat16, dev, seed=20)
    kw = dict(kv_len=torch.tensor([200], dtype=torch.int32, device=dev)) if causal else {}
    _check(q, k, v, g, causal=causal, route=route, **kw)


@pytest.mark.parametrize("T", EDGES)
@ROUTES
def test_kernels_square_causal_edges(dev, T, route):
    q, k, v, g = _inputs(2, T, T, 4, 4, 40, torch.bfloat16, dev, seed=22)
    _check(q, k, v, g, causal=True, route=route)


@pytest.mark.parametrize("kv_len", [(40, 70), (100, 128), (129, 300), (385, 400), (60, 399)])
@pytest.mark.parametrize("causal", [False, True])
@ROUTES
def test_kernels_kv_len_inside_first_and_last_tile(dev, kv_len, causal, route):
    # Tens of live keys at least: with a handful, P is of order 1 and its bf16
    # rounding alone (2^-9 relative, 600 summands) passes the 2e-2 of the bound.
    q, k, v, g = _inputs(2, 150, 400, 8, 2, 64, torch.bfloat16, dev, seed=23)
    kw = dict(kv_len=torch.tensor(kv_len, dtype=torch.int32, device=dev))
    if causal:
        kw["q_offset"] = torch.tensor([0, 250], dtype=torch.int32, device=dev)
    _check(q, k, v, g, causal=causal, route=route, **kw)


@pytest.mark.parametrize("conv", ["suffix", "kv_len", "q_offset", "q_offset_scalar"])
@pytest.mark.parametrize("D", [16, 40, 64, 80, 128])
@pytest.mark.parametrize("heads", [(32, 8), (8, 8)])
@ROUTES
def test_kernels_conventions_head_dims_and_groups(dev, conv, D, heads, route):
    q, k, v, g = _inputs(2, 140, 300, *heads, D, torch.bfloat16, dev, seed=24)
    kw = dict(causal=True)
    if conv != "suffix":
        kw["kv_len"] = torch.tensor([200, 300], dtype=torch.int32, device=dev)
    if conv == "q_offset":
        kw["q_offset"] = torch.tensor([60, 129], dtype=torch.int32, device=dev)
    if conv == "q_offset_scalar":
        kw["q_offset"] = 57
    _check(q, k, v, g, route=route, **kw)


@pytest.mark.parametrize("D,heads", [(128, (32, 8)), (80, (8, 8)), (40, (8, 8)), (16, (8, 2))])
@pytest.mark.parametrize("case", ["causal", "full", "kv_len", "q_offset", "g_lse"])
@ROUTES
def test_kernels_ragged_items_over_several_tiles(dev, route, D, heads, case):
    # ragged T and S over several 128-row items and 64-key tiles; at least 40
    # live keys per sample
    B, T, S = 2, 333, 333 if case in ("causal", "g_lse") else 500
    q, k, v, g = _inputs(B, T, S, *heads, D, torch.bfloat16, dev, seed=27)
    kw = dict(causal=case != "full")
    if case in ("kv_len", "q_offset"):
        kw["kv_len"] = torch.tensor([450, 340], dtype=torch.int32, device=dev)
    if case == "q_offset":
        kw["q_offset"] = torch.tensor([100, 7], dtype=torch.int32, device=dev)
    g_lse = (torch.from_numpy(np.random.default_rng(28).standard_normal(
        (B, heads[0], T), dtype=np.float32)).to(dev) if case == "g_lse" else None)
    _check(q, k, v, g, g_lse=g_lse, route=route, **kw)


def test_wgmma_backward_gives_the_same_bits_twice(dev):
    # One block owns its dq rows, one its dk/dv rows, summing the key tiles (the
    # group's heads and the q tiles) in a fixed order: no atomics, so two runs
    # agree to the bit.
    q, k, v, g = _inputs(2, 300, 300, 8, 2, 128, torch.bfloat16, dev, seed=26)
    out, lse = A.flash_attention_with_lse(q, k, v, causal=True)
    runs = [A.flash_backward(q, k, v, out, lse, g, causal=True, route="wgmma")
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("use_lse", [False, True])
def test_autograd_function_launches_the_kernels(dev, use_lse):
    q, k, v, w = _inputs(2, 96, 96, 4, 2, 64, torch.bfloat16, dev, seed=10)
    u = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (2, 4, 96), dtype=np.float32)).to(dev)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = (A.flash_attention.launches, A.flash_bwd_dq.launches, A.flash_bwd_dkv.launches)
    if use_lse:
        out, lse = A.flash_attention_with_lse(*leaves, causal=True)
        loss = (out.float() * w.float()).sum() + (lse * u).sum()
    else:
        out = A.flash_attention(*leaves, causal=True)
        loss = (out.float() * w.float()).sum()
    # a non-contiguous cotangent, as the output projection hands one back
    loss.backward()
    torch.cuda.synchronize()
    after = (A.flash_attention.launches, A.flash_bwd_dq.launches, A.flash_bwd_dkv.launches)
    assert after == tuple(b + 1 for b in before)
    out0, lse0 = A.flash_attention_with_lse(q, k, v, causal=True)
    want = A.flash_backward_reference(q, k, v, out0, lse0, w, causal=True,
                                      g_lse=u if use_lse else None)
    for name, leaf, b in zip(("dq", "dk", "dv"), leaves, want):
        _close(leaf.grad, b, 2e-2, 2.0 ** -7, name)


def test_autograd_noncontiguous_cotangent_and_checkpoint(dev):
    from torch.utils.checkpoint import checkpoint

    q, k, v, w = _inputs(1, 80, 80, 4, 4, 32, torch.bfloat16, dev, seed=12)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    wt = w.transpose(1, 2).contiguous()

    def block(a, b, c):
        # the transpose hands the Function a strided cotangent
        return A.flash_attention(a, b, c, causal=True).transpose(1, 2)

    before = (A.flash_attention.launches, A.flash_bwd_dq.launches, A.flash_bwd_dkv.launches)
    (checkpoint(block, *leaves, use_reentrant=False).float() * wt.float()).sum().backward()
    torch.cuda.synchronize()
    after = (A.flash_attention.launches, A.flash_bwd_dq.launches, A.flash_bwd_dkv.launches)
    assert after == (before[0] + 2, before[1] + 1, before[2] + 1)   # forward runs again
    out0, lse0 = A.flash_attention_with_lse(q, k, v, causal=True)
    want = A.flash_backward_reference(q, k, v, out0, lse0, w, causal=True)
    for name, leaf, b in zip(("dq", "dk", "dv"), leaves, want):
        _close(leaf.grad, b, 2e-2, 2.0 ** -7, name)


def test_backward_rejects_what_it_does_not_take(dev):
    q, k, v, g = _inputs(1, 16, 16, 2, 2, 64, torch.bfloat16, dev)
    out, lse = A.flash_attention_with_lse(q, k, v)
    with pytest.raises(ValueError):
        A.flash_backward(q, k, v, out, lse, g.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError):
        A.flash_backward(q, k, v, out, lse[:, :, :8].contiguous(), g)
    # the wgmma route named for what the rule does not send it: no fallback
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    before = A.flash_bwd_dq.launches, A.flash_bwd_dkv.launches
    with pytest.raises(ValueError):
        A.flash_backward(qf, kf, vf, out.float(), lse, gf, route="wgmma")
    live, off = A._live_and_offset(1, 16, 16, None, None, dev)
    with pytest.raises(ValueError):
        A.flash_bwd_dq(qf, kf, vf, gf, lse, A._delta(gf, out.float(), None), live, off, True,
                       None, route="wgmma")
    assert (A.flash_bwd_dq.launches, A.flash_bwd_dkv.launches) == before
