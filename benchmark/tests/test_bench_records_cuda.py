"""On the card: the program's launch records of a flash, a temporal-
attention and a GroupNorm call (contiguous and channels-last) hold the
shapes of the calls, the profiled slice finds each kernel's device
operations by the names the rooflines read and puts each under the launch
that made it, and every share comes out above 0 and at most 100%.

    python -m pytest benchmark/tests/test_bench_records_cuda.py -q

(skips without a CUDA device)."""

import types

import pytest


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the launches are the port's CUDA kernels")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_launch_records_equal_the_benchmark_slice_records(card):
    import torch
    from torch import nn

    from benchmark import readers
    from benchmark.profiling import Slice, compact
    from spider_tpu_torch.common import profiler as P
    from spider_tpu_torch.ops.attention import flash_attention
    from spider_tpu_torch.ops.group_norm import group_norm
    from spider_tpu_torch.ops.temporal_attention import temporal_attention

    g = torch.Generator(device=card).manual_seed(0)
    q, k, v = (torch.randn(2, 256, 8, 40, generator=g, device=card, dtype=torch.bfloat16)
               for _ in range(3))
    x = [torch.randn(2, 16, 64, 320, generator=g, device=card, dtype=torch.bfloat16)
         for _ in range(3)]
    img = torch.randn(2, 320, 64, 64, generator=g, device=card, dtype=torch.bfloat16)
    norm = nn.GroupNorm(32, 320).to(card, torch.bfloat16)
    with torch.no_grad():           # once outside the slice: builds the kernels
        flash_attention(q, k, v, causal=False)
        temporal_attention(*x, 8)
        group_norm(img, norm, silu=True)
        P.drain()
        with P.recording(), Slice(card) as sl:
            flash_attention(q, k, v, causal=False)
            temporal_attention(*x, 8)
            group_norm(img, norm, silu=True)
            group_norm(img.to(memory_format=torch.channels_last), norm)
    rec = compact(P.drain())
    by_kernel = rec.launches
    assert by_kernel["flash_attention"] == [dict(B=2, T=256, S=256, Hq=8, Hkv=8, D=40,
                                                 causal=False, elem_bytes=2)]
    assert by_kernel["temporal_attention"] == [dict(B=2, F=16, P=64, C=320, heads=8,
                                                    elem_bytes=2)]
    assert by_kernel["group_norm"] == [dict(N=2, C=320, L=4096, G=32, silu=True, elem_bytes=2),
                                       dict(N=2, C=320, L=4096, G=32, silu=False,
                                            elem_bytes=2)]
    for names in (("flash_fwd",), ("tattn",), ("stats_contig", "apply_contig"),
                  ("stats_cl", "apply_cl")):
        assert sl.kernel_s(*names) > 0, names
        mine = [op for op in sl.ops if any(n in op[0] for n in names)]
        assert all(t is not None and t <= s for _n, s, _e, t in mine), mine
    run = types.SimpleNamespace(slice=sl, window=dict(profiled=0, program_spans={0: rec}))
    for read in (readers.flash_fwd_roofline, readers.tattn_fwd_roofline,
                 readers.group_norm_roofline):
        assert 0 < read(run) <= 100, read.__name__
