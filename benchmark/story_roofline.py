"""The consistent self-attention of the story UNet (``unet2d._bank_attention``)
against its least time, and the readers of its span and launch records.

The program opens the span ``unet.story_attn`` around each consistent
self-attention (the self call, the bank call and their merge) and keeps a
launch record ``story_attention`` (B, g, T, K, heads, D, elem_bytes) of
each while recording. Its least time is that of one attention of every
row over its own T keys and its group's K bank keys, at ``roofline.py``'s
rates; whatever form the program takes (two calls merged through their
logsumexps, or one over the concatenated keys), this is the work.
"""

from __future__ import annotations

from typing import Optional

from benchmark import profiling, roofline

STORY_ATTN = "unet.story_attn"
UNET = "unet"


def story_attention_cost(B, g, T, K, heads, D, elem_bytes):
    """(bytes, operations) of one consistent self-attention: q, k, v and out
    [B, T, heads x D] and the bank's k and v [g, K, heads x D], each moved
    once; QK^T and PV of each of the B rows over T + K keys."""
    C = heads * D
    return elem_bytes * (4 * B * T * C + 2 * g * K * C), 4 * C * B * T * (T + K)


def _story_attn_s(p: profiling.Profiled) -> float:
    """Device seconds of the profiled slice's operations launched inside a
    ``unet.story_attn`` span."""
    inside = profiling.under(p.spans, STORY_ATTN)
    return sum(e - s for (_n, s, e, _t), sid in zip(p.slice.ops, p.launched_in)
               if inside.get(sid) is not None) / 1e9


def story_attn_ms(run) -> Optional[float]:
    """Device milliseconds a UNet call of the operations launched inside the
    program's ``unet.story_attn`` spans, over the profiled request."""
    p = profiling.profiled(run)
    calls = sum(v[0] == UNET for v in p.spans.values()) if p else 0
    sec = _story_attn_s(p) if calls else 0.0
    return 1e3 * sec / calls if sec > 0 else None


def story_attn_roofline(run) -> Optional[float]:
    """100 x the least time of the profiled request's ``story_attention``
    launch records over the device time of the operations launched inside
    ``unet.story_attn``."""
    p = profiling.profiled(run)
    if p is None:
        return None
    return roofline.share_percent(p.rec.launches.get("story_attention"), story_attention_cost,
                                  _story_attn_s(p))
