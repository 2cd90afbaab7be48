"""The paged decode-attention CUDA kernel against its plain PyTorch version.

These tests need an NVIDIA GPU: the kernel has no CPU mode, so without a
card they skip. They import torch only, so they also run where JAX is not
installed: ``python -m pytest --noconftest tests/test_torch_paged_cuda.py``.

Tolerances: bf16 inputs give the same bf16 operands to both versions; they
differ in summation order and in where sm_scale is applied (the kernel
scales q, the plain version the logits), and both round the output to
bf16, where one step is 2^-6 for |out| in [2, 4): out is held to 2e-2. In
fp32 only the summation order differs: 1e-4. The split kernel also rounds the
probabilities to bf16 for its second product (2^-9 relative, summed over the
live keys with weights that add to 1): the same 2e-2.

Every case runs on the route ``paged_route`` names ("split" for bf16, pages
that are multiples of 16 and head dims that are multiples of 16 up to 128;
else the first kernel, "simple") and on "simple"; "split" is run twice and
must give the same bits.
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


def _ruled(args):
    q, pool_k = args[0], args[1]
    return P.paged_route(q.dtype, pool_k.shape[1], q.shape[-1])


def _check(args, atol, route=None):
    """One launch through `route` ("ruled": the rule's, through
    paged_decode_attention) held to the plain version on the live slots;
    slots with kv_len = 0 must be 0. Returns the output."""
    fn = P.paged_decode_attention
    ruled = _ruled(args)
    named = ruled if route in (None, "ruled") else route
    before = (fn.launches, fn.route_launches[named])
    if route in (None, "ruled"):
        out = fn(*args)
    else:
        out = P.paged_decode_kernel(*args, route=route)
    torch.cuda.synchronize()
    assert (fn.launches, fn.route_launches[named]) == (before[0] + 1, before[1] + 1)
    want = P.paged_decode_reference(*args)
    q, lens = args[0], args[4]
    assert out.shape == q.shape and out.dtype == q.dtype
    assert torch.isfinite(out).all()
    live = lens > 0
    assert (out[~live] == 0).all()
    err = (out.float() - want.float())[live].abs().max().item()
    assert err <= atol, err
    return out


ROUTES = pytest.mark.parametrize("route", ["ruled", "simple"])


@ROUTES
def test_serving_shapes(dev, route):
    # The 8B decoder at 16 slots, page 128, max_len 512: kv_len at and around
    # page edges, a full window, and one past the table (the walk
    # must stop after max_pages pages).
    MP, page = 4, 128
    lens = [1, 127, 128, 129, 512, MP * page + 5, 300, 2, 255, 256, 257, 384, 511, 64, 65, 400]
    args = _inputs(16, 32, 8, 128, page, MP, 80, lens, torch.bfloat16, dev)
    assert _ruled(args) == "split"
    _check(args, 2e-2, route)


@ROUTES
def test_long_context_one_slot(dev, route):
    # The chat's long context: one slot, 14 pages, kv_len 1758.
    args = _inputs(1, 32, 8, 128, 128, 14, 20, [1758], torch.bfloat16, dev, seed=1)
    _check(args, 2e-2, route)


@ROUTES
@pytest.mark.parametrize("D", [8, 16, 40, 64, 112, 128, 256])
@pytest.mark.parametrize("group", [1, 4, 8, 20])
def test_head_dims_and_groups(dev, D, group, route):
    # Groups of 1, 4 and 8 query heads pad to the 16 rows of one mma tile; 20
    # take two. D 8, 40 and 256 belong to the first kernel by the rule.
    args = _inputs(3, 2 * group, 2, D, 16, 5, 20, [1, 33, 80], torch.bfloat16, dev, seed=2)
    assert _ruled(args) == ("split" if D in (16, 64, 112, 128) else "simple")
    _check(args, 2e-2, route)


def _split_edges(MP, page, B, Hkv, group):
    n_split, keys = P.split_plan(MP, page, B, Hkv, torch.cuda.get_device_properties(0)
                                 .multi_processor_count, group)
    assert n_split > 1
    return n_split, keys


@pytest.mark.parametrize("D,group", [(64, 1), (64, 8), (128, 4)])
def test_kv_len_at_split_edges(dev, D, group):
    # One key; the last key of split 0 and the first of split 1; a tile edge
    # inside a split; the second split wholly past kv_len; the last key of the
    # window and one past it.
    MP, page, Hkv = 8, 16, 2
    n_split, keys = _split_edges(MP, page, 8, Hkv, group)
    lens = [1, keys - 1, keys, keys + 1, 17, keys // 2, MP * page, MP * page + 3]
    args = _inputs(8, Hkv * group, Hkv, D, page, MP, 70, lens, torch.bfloat16, dev, seed=6)
    assert _ruled(args) == "split"
    _check(args, 2e-2)
    _check(args, 2e-2, "simple")


@pytest.mark.parametrize("B,MP,page,lens", [(16, 4, 128, None), (1, 14, 128, [1758]),
                                            (5, 8, 16, [0, 1, 77, 128, 0])])
def test_split_gives_the_same_bits_twice(dev, B, MP, page, lens):
    # The splits' partial results merge in split order, whichever block
    # arrives last: run it several times, with other launches between.
    lens = lens or [1, 127, 128, 129, 512, 517, 300, 2, 255, 256, 257, 384, 511, 64, 65, 400]
    args = _inputs(B, 32, 8, 128, page, MP, B * MP + 3, lens, torch.bfloat16, dev, seed=7)
    first = _check(args, 2e-2)
    other = _inputs(3, 8, 2, 64, 16, 5, 20, [1, 33, 80], torch.bfloat16, dev, seed=8)
    for _ in range(5):
        _check(other, 2e-2)
        again = P.paged_decode_attention(*args)
        torch.cuda.synchronize()
        assert torch.equal(first, again)


@pytest.mark.parametrize("dtype,page,D", [(torch.float32, 16, 64), (torch.bfloat16, 7, 64),
                                          (torch.bfloat16, 16, 40)])
def test_a_named_split_raises_on_what_the_rule_does_not_send_it(dev, dtype, page, D):
    args = _inputs(2, 8, 2, D, page, 4, 10, [5, 9], dtype, dev)
    fn = P.paged_decode_attention
    before = (fn.launches, dict(fn.route_launches))
    with pytest.raises(ValueError):
        P.paged_decode_kernel(*args, route="split")
    assert (fn.launches, fn.route_launches) == before


@pytest.mark.parametrize("page", [7, 48])
def test_pages_that_are_not_tile_multiples(dev, page):
    # The first kernel's tiles of 32 keys straddle pages of 7 and 48 rows; the
    # split kernel's 16-key tiles divide a page of 48, not one of 7.
    args = _inputs(4, 8, 2, 64, page, 6, 30, [1, page, 3 * page + 1, 6 * page], torch.bfloat16,
                   dev, seed=3)
    assert _ruled(args) == ("split" if page == 48 else "simple")
    _check(args, 2e-2)
    _check(args, 2e-2, "simple")


def test_fp32_pools(dev):
    args = _inputs(4, 8, 2, 64, 16, 4, 20, [5, 16, 40, 64], torch.float32, dev, seed=4)
    assert _ruled(args) == "simple"
    _check(args, 1e-4)


@ROUTES
def test_empty_slot_is_zero(dev, route):
    # kv_len = 0: the kernels give 0, as the TPU kernel does (the plain
    # gather route gives the mean of V there, so it is not compared).
    args = _inputs(2, 8, 2, 64, 16, 4, 10, [0, 20], torch.bfloat16, dev, seed=5)
    out = _check(args, 2e-2, route)
    assert (out[0] == 0).all()


def test_int64_table_and_lengths_are_cast(dev):
    q, pk, pv, table, lens = _inputs(3, 8, 2, 64, 16, 5, 20, [1, 33, 80], torch.bfloat16, dev)
    _check((q, pk, pv, table.long(), lens.long()), 2e-2)


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


@ROUTES
def test_qwen2_group_7(dev, route):
    # Qwen2-7B: 28 query heads over 4 KV heads, D 128, page 128. The split
    # kernel pads each group of 7 to its 16 rows; the padded rows must not
    # reach the output.
    lens = [1, 127, 128, 129, 300, 512, 5, 200]
    args = _inputs(8, 28, 4, 128, 128, 4, 40, lens, torch.bfloat16, dev, seed=30)
    assert _ruled(args) == "split"
    first = _check(args, 2e-2, route)
    again = (P.paged_decode_attention(*args) if route == "ruled"
             else P.paged_decode_kernel(*args, route=route))
    torch.cuda.synchronize()
    assert torch.equal(first, again)
