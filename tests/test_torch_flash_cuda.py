"""The flash-attention CUDA kernel against its plain PyTorch version.

These tests need an NVIDIA GPU: the kernel has no CPU mode, so without a
card they skip. They import torch only, so they also run where JAX is not
installed: ``python -m pytest --noconftest tests/test_torch_flash_cuda.py``.

Every bf16 case runs through both kernels, the "wgmma" route and the general
"mma" route (``ops/attention.py::flash_route``), each named by the call.

Tolerances: bf16 q/k/v give the same bf16 operands to both versions; they
differ in summation order, in the kernel rounding P to bf16 before P.V (as
the TPU kernel does) and in the bf16 rounding of the output, so out is held
to 2e-2 and the fp32 lse to 1e-3. fp32 inputs are rounded to bf16 for the
kernel's tensor cores, so there both are held to 3e-2.
"""

import ctypes

import numpy as np
import pytest
import torch

from spider_tpu_torch.ops import attention as A

pytestmark = pytest.mark.cuda
ROUTES = pytest.mark.parametrize("route", ["wgmma", "mma"])


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


def _check(q, k, v, atol_out, atol_lse, route=None, **kw):
    """Live rows only: every case here gives each query row a live key."""
    before = A.flash_attention.launches, dict(A.flash_attention.route_launches)
    out, lse = A.flash_attention_with_lse(q, k, v, route=route, **kw)
    torch.cuda.synchronize()
    took = route or A.flash_route(q.dtype, q.shape[-1])
    assert A.flash_attention.launches == before[0] + 1
    assert A.flash_attention.route_launches == {
        r: n + (r == took) for r, n in before[1].items()}
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
@ROUTES
def test_kernel_matches_plain_bf16(dev, D, group, causal, route):
    # T and S not multiples of the 64-row tiles: the kernel masks the edges.
    q, k, v = _inputs(2, 100, 100, 2 * group, 2, D, torch.bfloat16, dev)
    _check(q, k, v, 2e-2, 1e-3, route, causal=causal)


@pytest.mark.parametrize("conv", ["suffix", "kv_len", "q_offset"])
@ROUTES
def test_kernel_position_conventions(dev, conv, route):
    B, T, S = 2, 70, 150
    q, k, v = _inputs(B, T, S, 8, 2, 128, torch.bfloat16, dev, seed=1)
    kw = dict(causal=True)
    if conv in ("kv_len", "q_offset"):
        kw["kv_len"] = torch.tensor([90, 150], dtype=torch.int32, device=dev)
    if conv == "q_offset":
        kw["q_offset"] = torch.tensor([20, 80], dtype=torch.int32, device=dev)
    _check(q, k, v, 2e-2, 1e-3, route, **kw)


@ROUTES
def test_kernel_prefill_shape(dev, route):
    # The 8B prefill: the whole cache S = T + 150, kv_len = T, q_offset = 0.
    T = 300
    q, k, v = _inputs(1, T, T + 150, 32, 8, 128, torch.bfloat16, dev, seed=2)
    _check(q, k, v, 2e-2, 1e-3, route, causal=True,
           kv_len=torch.tensor([T], dtype=torch.int32, device=dev), q_offset=0)


@ROUTES
def test_kernel_unet_cross_attention_shape(dev, route):
    # SD level-0 cross-attention: D = 40 and 77 text keys, non-causal.
    q, k, v = _inputs(2, 4096, 77, 8, 8, 40, torch.bfloat16, dev, seed=3)
    _check(q, k, v, 2e-2, 1e-3, route, causal=False)


@pytest.mark.parametrize("T,S", [(300, 300), (500, 1)])
@ROUTES
def test_kernel_audioldm_shapes(dev, T, S, route):
    # AudioLDM level 0: D = 16; its cross-attention has one key (the CLAP vector).
    q, k, v = _inputs(2, T, S, 8, 8, 16, torch.bfloat16, dev, seed=5)
    _check(q, k, v, 2e-2, 1e-3, route, causal=False)


# Grounding DINO's decoder self-attention (B 1, 900 queries, D 32) and SAM
# ViT-H's mask decoder: prompt-token self-attention (D 32), token-to-image and
# image-to-token over the 64 x 64 grid (D 16), for a box prompt (7 tokens,
# B 1) and the MASK train step's text prompt (6 tokens, B 4).
GROUNDING_SHAPES = [(1, 900, 900, 32), (1, 7, 7, 32), (1, 7, 4096, 16), (1, 4096, 7, 16),
                    (4, 6, 6, 32), (4, 6, 4096, 16), (4, 4096, 6, 16)]


@pytest.mark.parametrize("B,T,S,D", GROUNDING_SHAPES)
@ROUTES
def test_kernel_grounding_and_sam_decoder_shapes(dev, B, T, S, D, route):
    q, k, v = _inputs(B, T, S, 8, 8, D, torch.bfloat16, dev, seed=T + S)
    _check(q, k, v, 2e-2, 1e-3, route, causal=False)


@pytest.mark.parametrize("route", [None, "mma"])
def test_kernel_fp32_inputs(dev, route):
    # fp32 is the general route's alone, by the rule and by name.
    q, k, v = _inputs(1, 130, 130, 4, 2, 64, torch.float32, dev, seed=4)
    assert A.flash_route(q.dtype, 64) == "mma"
    _check(q, k, v, 3e-2, 3e-2, route, causal=True)


@pytest.mark.parametrize("D", [36, 100])
def test_kernel_head_dims_off_the_tma_grid(dev, D):
    # D % 8 != 0: a tensor map cannot stride such rows; the rule sends them
    # to the general route.
    q, k, v = _inputs(2, 100, 100, 4, 2, D, torch.bfloat16, dev, seed=6)
    assert A.flash_route(q.dtype, D) == "mma"
    _check(q, k, v, 2e-2, 1e-3, causal=True)


# The wgmma route's tiles: 128 query rows a block (64 a warpgroup), 128 keys
# a tile. One below, at and one above one and two tiles; the general route's
# 64-row tiles see the same cases.
EDGES = [127, 128, 129, 255, 256, 257]


@pytest.mark.parametrize("T", EDGES)
@pytest.mark.parametrize("causal", [False, True])
@ROUTES
def test_kernel_query_tile_edges(dev, T, causal, route):
    q, k, v = _inputs(1, T, 200, 4, 2, 64, torch.bfloat16, dev, seed=20)
    # causal: queries start at 0 over a longer cache, so every row has a key
    kw = dict(kv_len=torch.tensor([200], dtype=torch.int32, device=dev)) if causal else {}
    _check(q, k, v, 2e-2, 1e-3, route, causal=causal, **kw)


@pytest.mark.parametrize("S", EDGES)
@pytest.mark.parametrize("causal", [False, True])
@ROUTES
def test_kernel_key_tile_edges(dev, S, causal, route):
    # causal under the suffix convention: the 70 queries are the last 70 keys
    q, k, v = _inputs(2, 70, S, 8, 2, 128, torch.bfloat16, dev, seed=21)
    _check(q, k, v, 2e-2, 1e-3, route, causal=causal)


@pytest.mark.parametrize("S", [1, 8, 31, 32, 33])
@pytest.mark.parametrize("D", [16, 128])
@ROUTES
def test_kernel_short_key_sequences(dev, S, D, route):
    # Up to 32 keys the wgmma route walks one 32-key tile, above it 128-key tiles.
    q, k, v = _inputs(2, 200, S, 8, 2, D, torch.bfloat16, dev, seed=27)
    _check(q, k, v, 2e-2, 1e-3, route, causal=False)
    kv_len = torch.tensor([S, max(1, S - 3)], dtype=torch.int32, device=dev)
    _check(q, k, v, 2e-2, 1e-3, route, causal=True, kv_len=kv_len, q_offset=S - 1)


@pytest.mark.parametrize("T", EDGES)
@ROUTES
def test_kernel_square_causal_edges(dev, T, route):
    q, k, v = _inputs(2, T, T, 4, 4, 40, torch.bfloat16, dev, seed=22)
    _check(q, k, v, 2e-2, 1e-3, route, causal=True)


@pytest.mark.parametrize("kv_len", [(40, 70), (100, 128), (129, 300), (385, 400), (60, 399)])
@pytest.mark.parametrize("causal", [False, True])
@ROUTES
def test_kernel_kv_len_inside_first_and_last_tile(dev, kv_len, causal, route):
    # S = 400 is four tiles of 128 (the last ragged): kv_len inside the
    # first, at a tile's end, inside the second, inside the last.
    q, k, v = _inputs(2, 150, 400, 8, 2, 64, torch.bfloat16, dev, seed=23)
    kw = dict(kv_len=torch.tensor(kv_len, dtype=torch.int32, device=dev))
    if causal:      # every query row at or past key 0 and a live key below it
        kw["q_offset"] = torch.tensor([0, 250], dtype=torch.int32, device=dev)
    _check(q, k, v, 2e-2, 1e-3, route, causal=causal, **kw)


@pytest.mark.parametrize("conv", ["suffix", "kv_len", "q_offset", "q_offset_scalar"])
@pytest.mark.parametrize("D", [16, 40, 64, 128])
@pytest.mark.parametrize("heads", [(32, 8), (8, 8)])
@ROUTES
def test_kernel_conventions_head_dims_and_groups(dev, conv, D, heads, route):
    B, T, S = 2, 140, 300
    q, k, v = _inputs(B, T, S, *heads, D, torch.bfloat16, dev, seed=24)
    kw = dict(causal=True)
    if conv != "suffix":
        kw["kv_len"] = torch.tensor([200, 300], dtype=torch.int32, device=dev)
    if conv == "q_offset":
        kw["q_offset"] = torch.tensor([60, 129], dtype=torch.int32, device=dev)
    if conv == "q_offset_scalar":
        kw["q_offset"] = 57
    _check(q, k, v, 2e-2, 1e-3, route, **kw)


def test_routes_agree_on_live_rows_and_stay_finite_on_dead_ones(dev):
    # kv_len 0 for the second sample: its rows have no live key. Both kernels
    # stay finite there (the mean of V over the tiles they visit, which differ
    # in width); the live sample agrees.
    q, k, v = _inputs(2, 130, 130, 4, 2, 64, torch.bfloat16, dev, seed=25)
    kv_len = torch.tensor([130, 0], dtype=torch.int32, device=dev)
    outs = [A.flash_attention_with_lse(q, k, v, causal=True, kv_len=kv_len, route=r)
            for r in ("wgmma", "mma")]
    torch.cuda.synchronize()
    for out, lse in outs:
        assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert (outs[0][0][0].float() - outs[1][0][0].float()).abs().max() <= 2e-2
    assert (outs[0][1][0] - outs[1][1][0]).abs().max() <= 1e-3


@pytest.mark.parametrize("mode", [0, 1])
def test_single_wgmma_product_matches_matmul(dev, mode):
    """csrc/wgmma_probe.cu: one product through hopper.cuh's TMA load,
    swizzled descriptors and wgmma wrappers. mode 0: both operands from
    shared memory, K-major, two boxes deep; mode 1: A from registers, B as it
    lies (MN-major, two boxes wide). fp32 accumulation of bf16 products: 1e-3
    covers the summation order over 128 (64) terms."""
    from spider_tpu_torch.ops import cuda_build

    lib = cuda_build.load("wgmma_probe")
    lib.spider_wgmma_probe.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4
    lib.spider_wgmma_probe.restype = ctypes.c_int
    rng = np.random.default_rng(30 + mode)
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(
        dev, torch.bfloat16)
    a, b = (mk(64, 128), mk(128, 128)) if mode == 0 else (mk(64, 64), mk(64, 128))
    d = torch.full((64, 128), float("nan"), device=dev)
    err = lib.spider_wgmma_probe(mode, a.data_ptr(), b.data_ptr(), d.data_ptr(),
                                 torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    want = a.float() @ (b.float().T if mode == 0 else b.float())
    assert (d - want).abs().max().item() <= 1e-3


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
    # the wgmma route named for what the rule does not send it: no fallback
    with pytest.raises(ValueError):
        A.flash_attention(q.float(), k.float(), v.float(), route="wgmma")
    q, k, v = _inputs(1, 16, 16, 2, 2, 36, torch.bfloat16, dev)
    with pytest.raises(ValueError):
        A.flash_attention(q, k, v, route="wgmma")
    with pytest.raises(ValueError):
        A.flash_attention(q, k, v, route="tma")


@pytest.mark.parametrize("conv", ["prefill", "suffix"])
@ROUTES
def test_kernel_qwen2_heads_group_7(dev, conv, route):
    # Qwen2-7B's 28 query heads over 4 KV heads: a group of 7, at its prefill
    # (T 128 over a cache of 160 with kv_len 128) and cache-free.
    if conv == "prefill":
        q, k, v = _inputs(1, 128, 160, 28, 4, 128, torch.bfloat16, dev, seed=40)
        kw = dict(kv_len=torch.tensor([128], dtype=torch.int32, device=dev), q_offset=0)
    else:
        q, k, v = _inputs(2, 150, 150, 28, 4, 128, torch.bfloat16, dev, seed=41)
        kw = {}
    _check(q, k, v, 2e-2, 1e-3, route, causal=True, **kw)


@pytest.mark.parametrize("offsets", [(128,), (128, 200), (0, 255)])
@pytest.mark.parametrize("heads", [(32, 8), (28, 4)])
@ROUTES
def test_kernel_speculative_verify_window(dev, offsets, heads, route):
    # The verify window of prompt-lookup speculation: T 8 queries at
    # q_offset = kv_len over a cache of S = T + N + G = 128 + 128 + 8 = 264,
    # kv_len + 8 keys live, per-batch offsets; 120 of the 128 rows of a
    # wgmma query tile are empty.
    B = len(offsets)
    q, k, v = _inputs(B, 8, 264, *heads, 128, torch.bfloat16, dev, seed=42 + B)
    off = torch.tensor(offsets, dtype=torch.int32, device=dev)
    _check(q, k, v, 2e-2, 1e-3, route, causal=True, kv_len=off + 8, q_offset=off)
