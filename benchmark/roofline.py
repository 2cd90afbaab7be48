"""The card's published peaks and the least time a kernel call could take.

Frozen copies of ``bound_ms`` and ``live_pairs`` of the repository's
``chip_smoke.py``: each input byte read once and each output byte written
once at the HBM rate, or the operations at the dense bf16 tensor rate,
whichever is longer, over the (query, key) pairs the mask leaves live. A
``*_cost`` takes the shape a kernel wrapper records at its launch
(``count_launch``), under the same keys.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12


def bound_s(moved_bytes: float, flops: float) -> float:
    return max(moved_bytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S)


def live_pairs(B: int, T: int, S: int, causal: bool) -> int:
    """Live (query, key) pairs of a call without padding: all T * S, or
    under a causal mask with the queries the last T of the S positions, the
    pairs at or before each query."""
    if not causal:
        return B * T * S
    return B * sum(min(S, S - T + t + 1) for t in range(T))


def flash_fwd_cost(B, T, S, Hq, Hkv, D, causal, elem_bytes):
    """(bytes, operations) of one flash forward: q and out [B,T,Hq,D], k and
    v [B,S,Hkv,D], the lse [B,Hq,T] in fp32; QK^T and PV."""
    moved = elem_bytes * (2 * B * T * Hq * D + 2 * B * S * Hkv * D) + 4 * B * Hq * T
    return moved, 4 * Hq * D * live_pairs(B, T, S, causal)


def tattn_fwd_cost(B, F, P, C, heads, elem_bytes):
    """(bytes, operations) of one temporal attention: q, k, v read and out
    written, [B,F,P,C] each; QK^T and PV over the F frames at every pixel."""
    return 4 * B * F * P * C * elem_bytes, 4 * B * P * F * F * C


def group_norm_cost(N, C, L, G, silu, elem_bytes):
    """(bytes, operations) of one GroupNorm (with its SiLU or not): x
    [N, C, L] read once and y written once; its few operations an element
    count as none, since the bytes bound it by two orders."""
    return 2 * N * C * L * elem_bytes, 0


def share_percent(launches, cost, measured_s: float):
    """100 x the least time of these launches over their measured device
    time; None where there is nothing to read."""
    if not launches or measured_s <= 0:
        return None
    least = sum(bound_s(*cost(**launch)) for launch in launches)
    return 100.0 * least / measured_s
