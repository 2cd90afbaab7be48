"""On the card: the program's launch records of a flash and a temporal-
attention call equal the records ``profiling.Slice`` takes by patching the
wrappers that launch them, so the rooflines may be read from either.

    python -m pytest benchmark/tests/test_bench_program_spans_cuda.py -q

(skips without a CUDA device)."""

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

    from benchmark.profiling import Slice
    from spider_tpu_torch.common import profiler as P
    from spider_tpu_torch.ops.attention import flash_attention
    from spider_tpu_torch.ops.temporal_attention import temporal_attention

    g = torch.Generator(device=card).manual_seed(0)
    q, k, v = (torch.randn(2, 256, 8, 40, generator=g, device=card, dtype=torch.bfloat16)
               for _ in range(3))
    x = [torch.randn(2, 16, 64, 320, generator=g, device=card, dtype=torch.bfloat16)
         for _ in range(3)]
    P.drain()
    with Slice(card) as sl, P.recording():
        flash_attention(q, k, v, causal=False)
        temporal_attention(*x, 8)
    rec = P.drain()
    by_kernel = {r.kernel: r.shape for r in rec.launches}
    assert sl.launches["flash_fwd"] == [by_kernel["flash_attention"]]
    assert sl.launches["tattn_fwd"] == [by_kernel["temporal_attention"]]
