"""Ring attention's block steps on the flash kernels (ops/ring_attention.py)
against the plain form, and the ring of one through an NCCL world.

These tests need an NVIDIA GPU: the kernels have no CPU mode, so without a
card they skip. They import torch only:
``python -m pytest --noconftest tests/test_torch_ring_cuda.py``.

The three kinds of ring block, q_offset +T_local (a past block: every pair
live), 0 (the diagonal) and -T_local (after the diagonal: no live key), run
the forward, dq and dk/dv kernels on both routes ("wgmma" and the general
"mma", named by the call), each against its plain version on the same
inputs: out within 2e-2 and lse within 1e-3 on live rows (fp32 inputs,
rounded to bf16 for the tensor cores, 3e-2 both, as
tests/test_torch_flash_cuda.py holds them), gradients within 2e-2 + 2^-7
|plain|. The backward takes the lse and output of the ring's merge over the
block and the diagonal, as a rank's backward does. A dead block's lse from
the kernel is finite and its merge leaves the running output and lse bit
for bit unchanged; every ring of 2 and 4 run in one process equals one
kernel call over the whole sequence within the same bounds.
"""

import numpy as np
import pytest
import torch

from spider_tpu_torch.ops import attention as A
from spider_tpu_torch.ops import ring_attention as R

pytestmark = pytest.mark.cuda
ROUTES = pytest.mark.parametrize("route", ["wgmma", "mma"])
OFFSETS = pytest.mark.parametrize("rel", [1, 0, -1], ids=["past", "diagonal", "after"])


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, T, Hq, Hkv, D, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(dev, dtype)
    return mk(B, T, Hq, D), mk(B, T, Hkv, D), mk(B, T, Hkv, D), mk(B, T, Hq, D)


BWD = (2e-2, 2.0 ** -7)      # bf16 gradients: atol, relative


def _close(got, want, atol, rel, name):
    d = (got.float() - want.float()).abs()
    excess = (d - (atol + rel * want.float().abs())).max().item()
    assert excess <= 0, f"{name}: exceeds the bound by {excess}"


def _call_route(route):
    """Run the kernels of one route: the wrappers take `route` by keyword."""
    def block(q, k, v, rel):
        return A._flash_cuda(q, k, v, True, None, None, rel, route)

    def backward(q, k, v, out, lse, g, rel):
        B, T = q.shape[:2]
        live, off = A._live_and_offset(B, T, k.shape[1], None, rel, q.device)
        args = (q, k, v, g, lse, R.ring_delta(out, g), live, off, True, None)
        return (A.flash_bwd_dq(*args, route=route),) + A.flash_bwd_dkv(*args, route=route)

    return block, backward


@ROUTES
@OFFSETS
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_ring_block_forward_against_the_plain_form(dev, route, rel, dtype):
    if route == "wgmma" and dtype != torch.bfloat16:
        pytest.skip("the wgmma route takes bf16")
    B, T, Hq, Hkv, D = 1, 256, 8, 2, 128
    q, k, v, _ = _inputs(B, T, Hq, Hkv, D, dtype, dev)
    block, _ = _call_route(route)
    before = A.flash_attention.route_launches[route]
    o, lse = block(q, k, v, rel * T)
    assert A.flash_attention.route_launches[route] == before + 1
    po, plse = A.mha_reference_with_lse(q.float(), k.float(), v.float(), causal=True,
                                        q_offset=rel * T)
    live = torch.isfinite(plse)
    # past and diagonal blocks have a live key on every row, later ones on none
    assert bool(live.all()) == bool(live.any()) == (rel >= 0)
    assert torch.isfinite(lse).all()                  # the kernel's lse stays finite
    out_tol, lse_tol = (2e-2, 1e-3) if dtype == torch.bfloat16 else (3e-2, 3e-2)
    if live.any():
        rows = live.transpose(1, 2)[..., None].expand_as(o)
        assert (o.float() - po)[rows].abs().max().item() <= out_tol
        assert (lse - plse)[live].abs().max().item() <= lse_tol


@ROUTES
@OFFSETS
def test_ring_block_backward_against_the_plain_form(dev, route, rel):
    """dq, dk, dv of one block, from the output and lse of the merge over
    this block and the diagonal (a ring of two, seen from one rank)."""
    B, T, Hq, Hkv, D = 1, 256, 8, 2, 128
    q, k, v, g = _inputs(B, T, Hq, Hkv, D, torch.bfloat16, dev, seed=1)
    block, backward = _call_route(route)
    kb, vb = (x.roll(7, dims=1).contiguous() for x in (k, v))    # another block's keys
    o_run, lse_run = R.merge(*R._initial(q), *block(q, k, v, 0))
    if rel:
        o_run, lse_run = R.merge(o_run, lse_run, *block(q, kb, vb, rel * T))
    out, lse = o_run.to(q.dtype), lse_run
    got = backward(q, kb, vb, out, lse, g, rel * T)
    want = A.flash_backward_reference(q, kb, vb, out, lse, g, True, None, q_offset=rel * T)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(a, b, *BWD, name)
    if rel < 0:                                       # no live pair: exactly zero
        assert all(not x.any() for x in got)


@ROUTES
def test_a_dead_block_leaves_the_merge_bit_unchanged(dev, route):
    B, T, Hq, Hkv, D = 1, 256, 8, 2, 128
    q, k, v, _ = _inputs(B, T, Hq, Hkv, D, torch.bfloat16, dev, seed=2)
    block, _ = _call_route(route)
    o_run, lse_run = R.merge(*R._initial(q), *block(q, k, v, 0))
    o_dead, lse_dead = block(q, k, v, -T)
    o, lse = R.merge(o_run, lse_run, o_dead, lse_dead)
    assert torch.equal(o, o_run) and torch.equal(lse, lse_run)


@pytest.mark.parametrize("n", [2, 4])
def test_the_ring_in_one_process_equals_one_call_over_the_sequence(dev, n):
    B, T, Hq, Hkv, D = 1, 1024, 8, 2, 128
    q, k, v, g = _inputs(B, T, Hq, Hkv, D, torch.bfloat16, dev, seed=3)
    split = lambda x: [c.contiguous() for c in x.chunk(n, dim=1)]
    before = dict(A.flash_attention.route_launches)
    outs, lses, dqs, dks, dvs = R.ring_attention_ranks(split(q), split(k), split(v), split(g))
    assert A.flash_attention.route_launches["wgmma"] == before["wgmma"] + n * n
    assert A.flash_attention.route_launches["mma"] == before["mma"]
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out, lse = A.flash_attention_with_lse(*leaves, causal=True)
    out.backward(g)
    assert (torch.cat(outs, 1).float() - out.float()).abs().max().item() <= 2e-2
    assert (torch.cat(lses, 2) - lse).abs().max().item() <= 1e-3
    for name, got, leaf in (("dq", dqs, leaves[0]), ("dk", dks, leaves[1]),
                            ("dv", dvs, leaves[2])):
        _close(torch.cat(got, 1), leaf.grad, *BWD, name)


def test_a_ring_of_one_through_nccl_is_flash_attention(dev):
    from spider_tpu_torch.common import dist
    from spider_tpu_torch.parallel.collectives import group_of

    if dist.is_dist_avail_and_initialized():
        pytest.skip("a process group is already initialised in this process")
    dist.init_distributed_mode(dev)
    try:
        group = group_of(dist.make_mesh(), (dist.AXIS_CONTEXT,))
        q, k, v, g = _inputs(1, 512, 8, 2, 128, torch.bfloat16, dev, seed=4)
        results = []
        for fn in (lambda *x: R.ring_attention(*x, group), lambda *x: A.flash_attention(*x)):
            leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
            out = fn(*leaves)
            out.backward(g)
            results.append([out] + [x.grad for x in leaves])
        assert all(torch.equal(a, b) for a, b in zip(*results))
    finally:
        dist.destroy()
