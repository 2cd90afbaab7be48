"""The arithmetic behind the metric readers of ``metrics/``. Each takes the
finished run (``run.Run``) and returns a number, or None where the run has
nothing to read for it."""

from __future__ import annotations

import statistics
from typing import List, Optional

from benchmark import roofline


def setup_s(run) -> float:
    return run.setup_s


def mean_request_s(run) -> Optional[float]:
    """The window's seconds, from its start to the last completion, over the
    requests completed."""
    w = run.window
    done = w["attempted"] - w["failed"]
    return w["window_s"] / done if done else None


def p90_request_s(run) -> Optional[float]:
    """The 90th percentile of every request latency of the window."""
    lat = run.window["latencies"]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=10, method="inclusive")[8]


def _traced(run) -> List[dict]:
    """Span sets of the traced window's requests, the profiled one left out."""
    if run.spans is None:
        return []
    return [s for i, s in sorted(run.spans.items())
            if i >= 0 and i != run.window["profiled"] and "request" in s]


def _mean_ms(values) -> Optional[float]:
    values = list(values)
    return 1e3 * statistics.fmean(values) if values else None


def _total(spans, kind) -> float:
    return sum(e - s for s, e in spans.get(kind, []))


def controller_ms(run) -> Optional[float]:
    """A request's host time outside its decoder calls: tag parsing and
    dispatch."""
    return _mean_ms(_total(s, "request") - _total(s, "decoder") for s in _traced(run))


def denoise_ms(run) -> Optional[float]:
    """A span's CFG DDIM loop, ended in a synchronise."""
    return _mean_ms(e - b for s in _traced(run) for b, e in s.get("denoise", []))


def vae_decode_ms(run) -> Optional[float]:
    """A span's decode of its latents, to the copy on the host."""
    return _mean_ms(e - b for s in _traced(run) for b, e in s.get("vae_decode", []))


def mfu(run) -> Optional[float]:
    """100 x the model operations of the traced requests outside the
    profiled slice over their time, against the bf16 dense peak."""
    spans = _traced(run)
    if not spans or run.flops is None:
        return None
    ops = sum(run.flops["total"] * len(s.get("decoder", [])) for s in spans)
    sec = sum(_total(s, "request") for s in spans)
    return 100.0 * ops / sec / roofline.BF16_FLOP_PER_S if sec > 0 else None


def flash_fwd_roofline(run) -> Optional[float]:
    sl = run.slice
    if sl is None:
        return None
    return roofline.share_percent(sl.launches.get("flash_fwd"), roofline.flash_fwd_cost,
                                  sl.kernel_s("flash_fwd"))


def tattn_fwd_roofline(run) -> Optional[float]:
    sl = run.slice
    if sl is None:
        return None
    return roofline.share_percent(sl.launches.get("tattn_fwd"), roofline.tattn_fwd_cost,
                                  sl.kernel_s("tattn"))


def device_idle(run) -> Optional[float]:
    """100 x the share of the profiled slice's wall time with no device
    operation running."""
    sl = run.slice
    if sl is None or sl.wall_s <= 0:
        return None
    busy = sl.busy_s()
    return 100.0 * (1.0 - busy / sl.wall_s) if busy > 0 else None
