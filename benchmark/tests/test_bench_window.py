"""The window's statistics and the profiled slice's arithmetic on synthetic
runs."""

import statistics

import pytest

from benchmark import readers
from benchmark.profiling import Slice


class Run:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def test_mean_is_all_the_window_over_all_completed_requests():
    lat = [1.0, 1.2, 0.9, 3.0]
    run = Run(window=dict(window_s=6.5, latencies=lat, attempted=4, failed=0))
    assert readers.mean_request_s(run) == pytest.approx(6.5 / 4)
    run.window["failed"] = 1
    assert readers.mean_request_s(run) == pytest.approx(6.5 / 3)


def test_p90_is_over_every_request():
    lat = [float(i) for i in range(1, 41)]
    run = Run(window=dict(latencies=lat))
    assert readers.p90_request_s(run) == pytest.approx(
        statistics.quantiles(lat, n=10, method="inclusive")[8])
    assert 36.0 <= readers.p90_request_s(run) <= 37.0
    assert readers.p90_request_s(Run(window=dict(latencies=[1.0]))) is None


def _spans():
    return {
        0: dict(request=[(0.0, 1.0)], decoder=[(0.001, 0.999)], denoise=[(0.01, 0.9)],
                vae_decode=[(0.9, 0.99)]),
        1: dict(request=[(1.0, 2.2)], decoder=[(1.002, 2.198)], denoise=[(1.01, 2.0)],
                vae_decode=[(2.0, 2.19)]),
        2: dict(request=[(2.2, 9.0)], decoder=[(2.2, 9.0)]),     # the profiled one
    }


def test_span_readers_leave_out_the_profiled_request():
    run = Run(spans=_spans(), window=dict(profiled=2), slice=None, flops={"total": 1e12})
    assert readers.controller_ms(run) == pytest.approx(1e3 * (0.002 + 0.004) / 2)
    assert readers.denoise_ms(run) == pytest.approx(1e3 * (0.89 + 0.99) / 2)
    assert readers.vae_decode_ms(run) == pytest.approx(1e3 * (0.09 + 0.19) / 2)
    assert readers.mfu(run) == pytest.approx(100 * 2e12 / 2.2 / 989e12)
    assert readers.device_idle(run) is None and readers.flash_fwd_roofline(run) is None


def _slice(events, wall_s):
    s = Slice("cpu")
    s.events, s.wall_s = events, wall_s
    return s


def test_idle_share_from_a_synthetic_timeline():
    # device ops (us): [0, 100], [50, 150] overlap -> 150; [400, 500]; wall 1 ms
    ev = [("k1", 0.0, 100.0), ("k2", 50.0, 150.0), ("k3", 400.0, 500.0)]
    s = _slice(ev, 1e-3)
    assert s.busy_s() == pytest.approx(250e-6)
    assert readers.device_idle(Run(slice=s)) == pytest.approx(75.0)
    assert s.idle_gaps() == [["before k3", pytest.approx(250e-6)]]
    assert s.kernel_s("k") == pytest.approx(300e-6)
    assert s.device_ops(2) == [["k1", pytest.approx(100e-6)], ["k2", pytest.approx(100e-6)]]


def test_roofline_reader_uses_the_recorded_launches():
    s = _slice([("flash_fwd_wgmma_kernel", 0.0, 10.0)], 1e-3)
    s.launches = {"flash_fwd": [dict(B=2, T=4096, S=4096, Hq=8, Hkv=8, D=40, causal=False,
                                     elem_bytes=2)], "tattn_fwd": []}
    got = readers.flash_fwd_roofline(Run(slice=s))
    assert got == pytest.approx(100 * (4 * 8 * 40 * 2 * 4096 * 4096 / 989e12) / 10e-6)
    assert readers.tattn_fwd_roofline(Run(slice=s)) is None
