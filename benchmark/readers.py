"""The arithmetic behind the metric readers of ``metrics/``. Each takes the
finished run (``run.Run``) and returns a number, or None where the run has
nothing to read for it.

A traced run's window holds ``program_spans``: {request index: the
program's spans and launch records drained after it, as a
``profiling.Recorded``}. The kernels' rooflines read the profiled request's
launch records (the shapes each wrapper passes to ``count_launch``) against
the slice's device time of the kernels' operations."""

from __future__ import annotations

import statistics
from typing import List, Optional

from benchmark import profiling, roofline

UNET = "unet"


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


def _launch_roofline(run, kernel: str, cost, *op_names: str) -> Optional[float]:
    """100 x the least time of the profiled request's `kernel` launch
    records over the slice's device time of the operations whose names hold
    one of `op_names`."""
    recs = run.window.get("program_spans")
    rec = recs.get(run.window["profiled"]) if recs else None
    if rec is None or run.slice is None:
        return None
    shapes = rec.launches.get(kernel)
    return roofline.share_percent(shapes, cost, run.slice.kernel_s(*op_names))


def flash_fwd_roofline(run) -> Optional[float]:
    return _launch_roofline(run, "flash_attention", roofline.flash_fwd_cost, "flash_fwd")


def tattn_fwd_roofline(run) -> Optional[float]:
    return _launch_roofline(run, "temporal_attention", roofline.tattn_fwd_cost, "tattn")


def group_norm_roofline(run) -> Optional[float]:
    """``csrc/group_norm.cu``'s two passes, in either layout."""
    return _launch_roofline(run, "group_norm", roofline.group_norm_cost, "stats_contig",
                            "apply_contig", "stats_cl", "apply_cl")


def device_idle(run) -> Optional[float]:
    """100 x the share of the profiled slice's wall time with no device
    operation running."""
    sl = run.slice
    if sl is None or sl.wall_s <= 0:
        return None
    busy = sl.busy_s()
    return 100.0 * (1.0 - busy / sl.wall_s) if busy > 0 else None


def unet_host_ms(run) -> Optional[float]:
    """Mean host length of the program's ``unet`` spans over the traced
    requests outside the profiled slice (the warm-up left out)."""
    recs = run.window.get("program_spans")
    if not recs:
        return None
    lengths = [e - s for i, rec in recs.items() if i >= 0 and i != run.window["profiled"]
               for name, _id, _parent, s, e in rec.spans if name == UNET]
    return sum(lengths) / len(lengths) / 1e6 if lengths else None


def unet_kernels(run) -> Optional[float]:
    """Device operations launched inside one ``unet`` span, mean over the
    profiled slice's UNet calls."""
    p = profiling.profiled(run)
    calls = sum(v[0] == UNET for v in p.spans.values()) if p else 0
    if not calls:
        return None
    in_unet = profiling.under(p.spans, UNET)
    return sum(in_unet.get(sid) is not None for sid in p.launched_in) / calls


def unet_launch_idle(run) -> Optional[float]:
    """100 x the profiled slice's device-idle seconds during which the host
    was inside a ``unet`` span, over the slice's wall seconds."""
    p = profiling.profiled(run)
    if p is None or p.slice.wall_s <= 0:
        return None
    in_unet = profiling.under(p.spans, UNET)
    ns = sum(v for sid, v in p.idle_by().items() if in_unet.get(sid) is not None)
    return 100.0 * ns / 1e9 / p.slice.wall_s
