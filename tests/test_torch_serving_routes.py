"""The routing rules and launch plans of the two serving kernels, on the CPU.

``ops/quant.py::int4_route`` and ``ops/paged_attention.py::paged_route`` are
pure functions: they are held here to every shape the serving main path
gives them (llama3_8b: decode at 1 and 16 rows, prefill buckets of 128 to
1024 rows; pages of 128 keys, head dim 128) and to each excluded case. The
launch plans (``stream_plan``, ``wgmma_plan``, ``split_plan``) are pure too:
their tiles, slices and splits must cover the work exactly once. The split
kernel's arithmetic has a plain PyTorch version,
``paged_decode_reference_split``; it is held to ``paged_decode_reference``
at 1e-5 in fp32 (summation order only) and to the JAX package's Pallas
kernel in interpret mode at 2e-5, the bound tests/test_torch_paged.py holds
the plain version to.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spider_tpu.ops.paged_attention import paged_decode_attention as j_paged
from spider_tpu_torch.ops import paged_attention as P
from spider_tpu_torch.ops import quant as Q

SMS = 132                                     # an H100's SM count; the plans take any
# llama3_8b's projections as (K/2, N): q/o, k/v, gate/up, down, lm_head.
PROJECTIONS = {"q_o": (2048, 4096), "k_v": (2048, 1024), "gate_up": (2048, 14336),
               "down": (7168, 4096), "lm_head": (2048, 128256)}


# ---------------------------------------------------------------------------
# int4_route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(PROJECTIONS))
@pytest.mark.parametrize("M,want", [(1, "stream"), (16, "stream"), (128, "wgmma"),
                                    (256, "wgmma"), (512, "wgmma"), (1024, "wgmma")])
def test_int4_route_on_the_main_path(name, M, want):
    K2, _ = PROJECTIONS[name]
    if want == "stream" and K2 > Q.STREAM_MAX_K2:
        want = "mma"          # down at decode: the stream form reads whole rows of <= 2048 bytes
    assert Q.int4_route(torch.bfloat16, M, K2, True) == want


@pytest.mark.parametrize("dtype,M,K2,aligned,want", [
    (torch.float32, 16, 2048, True, "mma"),       # fp32 x: the hi + lo split lives there
    (torch.float32, 128, 2048, True, "mma"),
    (torch.bfloat16, 16, 2050, True, "mma"),      # K/2 no TMA row pitch
    (torch.bfloat16, 128, 2056, True, "mma"),
    (torch.bfloat16, 16, 2048, False, "mma"),     # a pointer off 16 bytes
    (torch.bfloat16, 1024, 2048, False, "mma"),
    (torch.bfloat16, 17, 2048, True, "mma"),      # between the two new forms
    (torch.bfloat16, 47, 2048, True, "mma"),
    (torch.bfloat16, 48, 2048, True, "wgmma"),
    (torch.bfloat16, 16, 2032, True, "stream"),   # a multiple of 16 is enough
    (torch.bfloat16, 16, 2064, True, "mma"),      # over the stream form's one slice
    (torch.bfloat16, 1, 7168, True, "mma"),
    (torch.bfloat16, 128, 7168, True, "wgmma"),   # the wgmma form cuts K itself
])
def test_int4_route_excluded_cases(dtype, M, K2, aligned, want):
    assert Q.int4_route(dtype, M, K2, aligned) == want


def _int4_inputs(M, K, N, dtype):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((M, K), dtype=np.float32)).to(dtype)
    w = torch.from_numpy(rng.integers(-8, 8, size=(K, N)).astype(np.int8))
    return x, Q.pack_int4(w).t().contiguous(), torch.ones(N)


@pytest.mark.parametrize("route,M,dtype", [
    ("stream", 16, torch.bfloat16),     # the rule's own route, but a CPU tensor
    ("wgmma", 128, torch.bfloat16),
    ("mma", 16, torch.float32),
    ("stream", 128, torch.bfloat16),    # the rule sends it to "wgmma"
    ("wgmma", 16, torch.bfloat16),      # and this one to "stream"
    ("stream", 16, torch.float32),      # fp32 belongs to "mma"
    ("wgmma", 32, torch.bfloat16),      # 17..47 rows belong to "mma"
    ("ring", 16, torch.bfloat16),       # no such route
])
def test_int4_named_route_raises_and_counts_nothing(route, M, dtype):
    x, packed, scale = _int4_inputs(M, 64, 32, dtype)
    before = (Q.int4_matmul.launches, dict(Q.int4_matmul.route_launches))
    with pytest.raises(ValueError):
        Q.int4_matmul_kernel(x, packed, scale, route=route)
    assert (Q.int4_matmul.launches, Q.int4_matmul.route_launches) == before


def test_int4_cpu_tensors_take_the_plain_version():
    x, packed, scale = _int4_inputs(16, 64, 32, torch.float32)
    before = Q.int4_matmul.launches
    torch.testing.assert_close(Q.int4_matmul(x, packed, scale),
                               Q.int4_matmul_reference(x, packed, scale))
    assert Q.int4_matmul.launches == before
    assert set(Q.int4_matmul.route_launches) == set(Q.ROUTES)


# ---------------------------------------------------------------------------
# the int4 plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [n for n, (K2, _) in PROJECTIONS.items() if K2 <= 2048])
@pytest.mark.parametrize("sms", [132, 108, 8])
def test_stream_plan_covers_every_tile_once(name, sms):
    _, N = PROJECTIONS[name]
    tiles, blocks = Q.stream_plan(N, sms)
    assert tiles * 16 >= N > (tiles - 1) * 16
    assert 1 <= blocks <= min(sms, tiles)                 # one block an SM, none without work
    # the kernel's split of the tiles over its blocks
    runs = [(tiles * i // blocks, tiles * (i + 1) // blocks) for i in range(blocks)]
    assert runs[0][0] == 0 and runs[-1][1] == tiles
    assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
    assert all(hi > lo for lo, hi in runs)
    assert max(hi - lo for lo, hi in runs) - min(hi - lo for lo, hi in runs) <= 1


def test_stream_plan_small_and_ragged():
    assert Q.stream_plan(9, 132) == (1, 1)
    assert Q.stream_plan(1000, 132) == (63, 63)           # never more blocks than tiles
    assert Q.stream_plan(128256, 132) == (8016, 132)


@pytest.mark.parametrize("name", list(PROJECTIONS))
@pytest.mark.parametrize("M", [48, 128, 256, 1000, 1024])
def test_wgmma_plan_covers_k_once(name, M):
    K2, N = PROJECTIONS[name]
    slices, tiles = Q.wgmma_plan(M, N, K2, SMS)
    assert tiles == -(-N // 128) * -(-M // 128)
    kt = -(-K2 // 64)
    kt_slice = -(-kt // slices)                           # as the C entry point derives it
    assert (slices - 1) * kt_slice < kt <= slices * kt_slice
    assert slices == 1 or slices * tiles <= SMS           # K is cut only to fill the card
    assert slices == 1 or kt_slice >= 4


def test_wgmma_plan_main_path_values():
    # gate/up at M 128 has 112 tiles for 132 SMs: one slice; down has 32: four.
    assert Q.wgmma_plan(128, 14336, 2048, SMS) == (1, 112)
    assert Q.wgmma_plan(128, 4096, 7168, SMS) == (4, 32)
    assert Q.wgmma_plan(1024, 14336, 2048, SMS) == (1, 896)


# ---------------------------------------------------------------------------
# paged_route and the split plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,page,D,want", [
    (torch.bfloat16, 128, 128, "split"),      # the batcher and the chat: llama3_8b
    (torch.bfloat16, 16, 64, "split"),
    (torch.bfloat16, 48, 64, "split"),        # three 16-key tiles a page
    (torch.bfloat16, 16, 16, "split"),
    (torch.float32, 128, 128, "simple"),      # fp32 pools
    (torch.float32, 16, 64, "simple"),
    (torch.bfloat16, 7, 64, "simple"),        # no tile divides the page
    (torch.bfloat16, 8, 64, "simple"),
    (torch.bfloat16, 16, 8, "simple"),        # head dims off the mma's 16
    (torch.bfloat16, 16, 40, "simple"),
    (torch.bfloat16, 16, 72, "simple"),
    (torch.bfloat16, 16, 256, "simple"),      # over the split kernel's registers
    (torch.bfloat16, 16, 144, "simple"),
])
def test_paged_route(dtype, page, D, want):
    assert P.paged_route(dtype, page, D) == want


def _paged_inputs(B, Hq, Hkv, D, page, MP, NB, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(0, 1, (B, Hq, D)).astype(np.float32)).to(dtype)
    pool_k, pool_v = (torch.from_numpy(rng.normal(0, 1, (NB, page, Hkv, D)).astype(np.float32))
                      .to(dtype) for _ in range(2))
    table = torch.from_numpy(rng.permutation(NB)[: B * MP].reshape(B, MP).astype(np.int32))
    return q, pool_k, pool_v, table


@pytest.mark.parametrize("route,dtype,page,D", [
    ("split", torch.bfloat16, 16, 64),       # the rule's own route, but CPU tensors
    ("simple", torch.float32, 16, 64),
    ("split", torch.float32, 16, 64),        # fp32 belongs to "simple"
    ("split", torch.bfloat16, 7, 64),        # so does a page no tile divides
    ("split", torch.bfloat16, 16, 40),       # and a head dim off 16
    ("ring", torch.bfloat16, 16, 64),        # no such route
])
def test_paged_named_route_raises_and_counts_nothing(route, dtype, page, D):
    q, pk, pv, table = _paged_inputs(2, 4, 2, D, page, 3, 8, dtype)
    lens = torch.tensor([5, 9], dtype=torch.int32)
    fn = P.paged_decode_attention
    before = (fn.launches, dict(fn.route_launches))
    with pytest.raises(ValueError):
        P.paged_decode_kernel(q, pk, pv, table, lens, route=route)
    assert (fn.launches, fn.route_launches) == before
    assert set(fn.route_launches) == set(P.ROUTES)


@pytest.mark.parametrize("max_pages,page,slots,kv_heads,group", [
    (4, 128, 16, 8, 4),        # serving: 16 slots, max_len 512
    (14, 128, 1, 8, 4),        # the chat's long context in one slot
    (4, 128, 1, 8, 4), (1, 16, 3, 2, 1), (5, 16, 3, 2, 8), (6, 48, 4, 2, 4),
    (64, 128, 2, 1, 20), (3, 16, 200, 8, 1),
])
@pytest.mark.parametrize("sms", [132, 16])
def test_split_plan_covers_every_key_once(max_pages, page, slots, kv_heads, group, sms):
    n_split, keys = P.split_plan(max_pages, page, slots, kv_heads, sms, group)
    window = max_pages * page
    assert n_split >= 1 and keys % P.SPLIT_KEYS == 0
    ranges = [(s * keys, min((s + 1) * keys, window)) for s in range(n_split)]
    assert ranges[0][0] == 0 and ranges[-1][1] == window            # the whole window
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))    # no gap, no overlap
    assert all(hi > lo for lo, hi in ranges)                        # no empty split
    # never finer than a tile for each of a block's warps, unless the window is
    assert keys >= min(window, P.SPLIT_KEYS * P.SPLIT_WARPS)
    # and no more splits than bring the grid to two blocks an SM
    blocks = slots * kv_heads * -(-group // P.SPLIT_ROWS)
    assert n_split == 1 or (n_split - 1) * blocks < 2 * sms


def test_split_plan_main_path_values():
    assert P.split_plan(4, 128, 16, 8, SMS, 4) == (3, 176)
    assert P.split_plan(14, 128, 1, 8, SMS, 4) == (28, 64)


def test_split_plan_does_not_read_kv_len():
    # A pure function of shapes and the SM count: no tensor among its arguments.
    import inspect

    assert list(inspect.signature(P.split_plan).parameters) == [
        "max_pages", "page", "slots", "kv_heads", "sms", "group"]


# ---------------------------------------------------------------------------
# the split kernel's arithmetic, in plain PyTorch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_len", [[5, 16, 64], [1, 33, 70], [17, 48, 31]])
@pytest.mark.parametrize("n_split,keys", [(1, 64), (2, 32), (4, 16), (3, 32)])
def test_split_reference_equals_plain(kv_len, n_split, keys):
    # page 16, 4 pages: splits that end inside a page, splits wholly past
    # kv_len, and one slot past the table (70 > 64: every key is live).
    q, pk, pv, table = _paged_inputs(3, 8, 2, 16, 16, 4, 14)
    lens = torch.tensor(kv_len, dtype=torch.int32)
    want = P.paged_decode_reference(q, pk, pv, table, lens)
    got = P.paged_decode_reference_split(q, pk, pv, table, lens, n_split=n_split,
                                         keys_per_split=keys)
    assert got.shape == want.shape and got.dtype == want.dtype
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_split_reference_with_the_plan_and_an_empty_slot():
    q, pk, pv, table = _paged_inputs(4, 8, 2, 32, 16, 12, 50, seed=1)
    lens = torch.tensor([0, 1, 70, 192], dtype=torch.int32)
    n_split, keys = P.split_plan(12, 16, 4, 2, 16, 4)
    assert n_split > 1
    got = P.paged_decode_reference_split(q, pk, pv, table, lens, n_split=n_split,
                                         keys_per_split=keys)
    want = P.paged_decode_reference(q, pk, pv, table, lens)
    assert (got[0] == 0).all()                     # kv_len = 0 gives 0, as the kernels do
    torch.testing.assert_close(got[1:], want[1:], atol=1e-5, rtol=0)


@pytest.mark.parametrize("sm_scale", [None, 0.3])
def test_split_reference_takes_sm_scale(sm_scale):
    q, pk, pv, table = _paged_inputs(2, 4, 4, 16, 16, 2, 6, seed=2)
    lens = torch.tensor([20, 32], dtype=torch.int32)
    got = P.paged_decode_reference_split(q, pk, pv, table, lens, sm_scale, n_split=2,
                                         keys_per_split=16)
    want = P.paged_decode_reference(q, pk, pv, table, lens, sm_scale)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kv_len", [[5, 16, 32], [1, 33, 40]])
def test_split_reference_equals_pallas_interpret(kv_len):
    # tests/test_torch_paged.py's case, with the window of 32 keys cut in two
    # splits of 16: in the first case slot 0 leaves the second split empty.
    B, Hq, Hkv, D, page, MP, NB = 3, 8, 2, 16, 8, 4, 12
    rng = np.random.default_rng(0)
    q = rng.normal(0, 1, (B, Hq, D)).astype(np.float32)
    pool_k = rng.normal(0, 1, (NB, page, Hkv, D)).astype(np.float32)
    pool_v = rng.normal(0, 1, (NB, page, Hkv, D)).astype(np.float32)
    table = rng.permutation(NB)[: B * MP].reshape(B, MP).astype(np.int32)
    lens = np.asarray(kv_len, np.int32)
    want = j_paged(jnp.asarray(q), jnp.asarray(pool_k), jnp.asarray(pool_v),
                   jnp.asarray(table), jnp.asarray(lens), interpret=True)
    got = P.paged_decode_reference_split(*(torch.from_numpy(a) for a in
                                           (q, pool_k, pool_v, table, lens)),
                                         n_split=2, keys_per_split=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
