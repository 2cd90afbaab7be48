"""The window's statistics and the profiled slice's arithmetic on synthetic
runs."""

import statistics

import pytest

from benchmark import readers
from benchmark.profiling import Slice, compact


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
    assert readers.unet_host_ms(run) is None and readers.unet_kernels(run) is None


def _slice(ops_us, wall_s):
    """A Slice holding device operations [(name, start us, end us)]."""
    s = Slice("cpu")
    s.ops = [(n, round(a * 1e3), round(b * 1e3), None) for n, a, b in ops_us]
    s.wall_s = wall_s
    return s


def test_idle_share_from_a_synthetic_timeline():
    # device ops (us): [0, 100], [50, 150] overlap -> 150; [400, 500]; wall 1 ms
    ev = [("k1", 0.0, 100.0), ("k2", 50.0, 150.0), ("k3", 400.0, 500.0)]
    s = _slice(ev, 1e-3)
    assert s.busy_s() == pytest.approx(250e-6)
    assert readers.device_idle(Run(slice=s)) == pytest.approx(75.0)
    assert s.idle_gaps() == [["outside any span: before k3", pytest.approx(250e-6)]]
    assert s.kernel_s("k") == pytest.approx(300e-6)
    assert s.kernel_s("k1", "k3") == pytest.approx(200e-6)
    assert s.device_ops(2) == [["k1", pytest.approx(100e-6)], ["k2", pytest.approx(100e-6)]]


def test_roofline_reader_uses_the_recorded_launches():
    from spider_tpu_torch.common.profiler import LaunchRecord, Recording

    s = _slice([("flash_fwd_wgmma_kernel", 0.0, 10.0)], 1e-3)
    shape = dict(B=2, T=4096, S=4096, Hq=8, Hkv=8, D=40, causal=False, elem_bytes=2)
    rec = compact(Recording([], [LaunchRecord("flash_attention", "wgmma", shape, None, 0)],
                            (0, 0)))
    run = Run(slice=s, window=dict(profiled=3, program_spans={3: rec}))
    got = readers.flash_fwd_roofline(run)
    assert got == pytest.approx(100 * (4 * 8 * 40 * 2 * 4096 * 4096 / 989e12) / 10e-6)
    assert readers.tattn_fwd_roofline(run) is None
    assert readers.group_norm_roofline(run) is None
    run.window["program_spans"] = {2: rec}          # another request's records
    assert readers.flash_fwd_roofline(run) is None


def test_the_slice_times_the_collections_inside_it():
    import gc

    enabled = gc.isenabled()
    with Slice("cpu") as sl:
        assert gc.isenabled() is enabled
        gc.collect()
    gc.collect()                                    # after the slice: not its
    assert len(sl.collections) == 1
    (s, e), = sl.collections
    assert sl.t0_ns <= s <= e <= sl.t1_ns
    assert sl._collection not in gc.callbacks
