"""The program's spans on the card's clock, and its launch records against
the shapes of the tensors launched.

These tests need an NVIDIA GPU and skip without one. They import torch and
the port only: ``python -m pytest --noconftest tests/test_torch_tracing_cuda.py``
from the root of the repository."""

import pytest
import torch

from spider_tpu_torch.common import profiler as P

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _fresh():
    P.drain()
    yield
    P.drain()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the device's clock and the CUDA kernels")
    return torch.device("cuda", 0)


def test_a_kernel_launched_in_a_span_starts_within_2ms_of_its_converted_start(card):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda._sleep(1000)
    torch.cuda.synchronize(card)
    with profile(activities=[ProfilerActivity.CUDA]) as prof, P.recording():
        torch.cuda.synchronize(card)                  # the stream is idle
        with P.span("sleep.launch"):
            torch.cuda._sleep(2_000_000)
        torch.cuda.synchronize(card)
    rec = P.drain()
    (s,) = rec.spans
    kernels = [e for e in prof.profiler.kineto_results.events()
               if "spin_kernel" in e.name() and not e.is_user_annotation()
               and e.device_type() == torch.autograd.DeviceType.CUDA]
    assert kernels, [e.name() for e in prof.profiler.kineto_results.events()]
    offset_ms = (kernels[0].start_ns() - rec.wall_ns(s.start_ns)) / 1e6
    print(f"sleep kernel start - converted span start: {offset_ms:.4f} ms")
    assert 0.0 <= offset_ms <= 2.0


def test_launch_records_hold_the_shapes_launched_under_the_open_span(card):
    from spider_tpu_torch.ops.attention import flash_attention
    from spider_tpu_torch.ops.temporal_attention import temporal_attention

    g = torch.Generator(device=card).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=card, dtype=torch.bfloat16)

    q, k, v = randn(2, 256, 8, 40), randn(2, 77, 8, 40), randn(2, 77, 8, 40)
    gq, gk, gv = randn(1, 100, 8, 64), randn(1, 100, 2, 64), randn(1, 100, 2, 64)
    x = [randn(2, 16, 64, 320) for _ in range(3)]
    flash_attention(q, k, v, causal=False)                # recording off: kept nowhere
    with P.recording():
        flash_attention(q, k, v, causal=False)
        with P.span("blocks"):
            flash_attention(gq, gk, gv, causal=True)
            temporal_attention(*x, 8)
    torch.cuda.synchronize(card)
    rec = P.drain()
    (blocks,) = rec.spans
    assert [(r.kernel, r.span, r.shape) for r in rec.launches] == [
        ("flash_attention", None,
         dict(B=2, T=256, S=77, Hq=8, Hkv=8, D=40, causal=False, elem_bytes=2)),
        ("flash_attention", blocks.id,
         dict(B=1, T=100, S=100, Hq=8, Hkv=2, D=64, causal=True, elem_bytes=2)),
        ("temporal_attention", blocks.id, dict(B=2, F=16, P=64, C=320, heads=8, elem_bytes=2))]
    assert blocks.start_ns <= rec.launches[1].t_ns <= rec.launches[2].t_ns <= blocks.end_ns
