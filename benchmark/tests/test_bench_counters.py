"""The yardstick's counters against hand-worked cases, and the model
operations of the cells against an independent count."""

import json
import os

import pytest

from benchmark import cells, roofline
from benchmark.flops import request_flops

DATA = os.path.join(os.path.dirname(__file__), "data")


def test_bound_takes_the_slower_of_bytes_and_operations():
    assert roofline.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 989e12) == pytest.approx(1.0)
    assert roofline.bound_s(3.35e12, 2 * 989e12) == pytest.approx(2.0)


@pytest.mark.parametrize("B,T,S,causal,pairs", [
    (2, 3, 5, False, 30),
    (1, 3, 3, True, 6),            # 1 + 2 + 3
    (1, 2, 4, True, 7),            # the last 2 of 4 positions: 3 + 4
    (3, 1, 6, True, 18),
])
def test_live_pairs(B, T, S, causal, pairs):
    assert roofline.live_pairs(B, T, S, causal) == pairs


def test_flash_cost_by_hand():
    # q, out: 2*4*2*8 elements; k, v: 2*6*1*8; 2 bytes each; lse 4 bytes * 2*2*4
    moved, ops = roofline.flash_fwd_cost(B=2, T=4, S=6, Hq=2, Hkv=1, D=8, causal=False,
                                         elem_bytes=2)
    assert moved == 2 * (2 * 2 * 4 * 2 * 8 + 2 * 2 * 6 * 1 * 8) + 4 * 2 * 2 * 4
    assert ops == 4 * 2 * 8 * (2 * 4 * 6)


def test_tattn_cost_by_hand():
    moved, ops = roofline.tattn_fwd_cost(B=1, F=4, P=10, C=16, heads=2, elem_bytes=2)
    assert moved == 4 * 1 * 4 * 10 * 16 * 2
    assert ops == 4 * 1 * 10 * 4 * 4 * 16


def test_group_norm_cost_by_hand():
    # x [2, 8, 3*5] read once and y written once, 2 bytes an element
    moved, ops = roofline.group_norm_cost(N=2, C=8, L=15, G=4, silu=True, elem_bytes=2)
    assert (moved, ops) == (2 * (2 * 8 * 15 * 2), 0)
    # ZeroScope's per-video level 0 (2, 320, 16, 2880): 59 MB each way, 0.0352 ms
    moved, _ = roofline.group_norm_cost(N=2, C=320, L=16 * 2880, G=32, silu=True, elem_bytes=2)
    assert moved == 2 * 58_982_400
    assert roofline.bound_s(moved, 0) * 1e3 == pytest.approx(0.0352, rel=0.01)


def test_share_percent():
    launch = dict(B=1, F=4, P=10, C=16, heads=2, elem_bytes=2)
    least = roofline.bound_s(*roofline.tattn_fwd_cost(**launch))
    assert roofline.share_percent([launch, launch], roofline.tattn_fwd_cost,
                                  4 * least) == pytest.approx(50.0)
    assert roofline.share_percent([], roofline.tattn_fwd_cost, 1.0) is None
    assert roofline.share_percent([launch], roofline.tattn_fwd_cost, 0.0) is None


def _tiny(name):
    with open(os.path.join(DATA, name + ".json")) as f:
        return json.load(f)


def test_text_encoder_operations_by_hand():
    cfg = _tiny("tiny_sd")
    point = _tiny("tiny_sd.image")["point"]
    t = cfg["text_encoder_as_run"]
    T, H, inter, L = 77, t["hidden_size"], t["intermediate_size"], t["num_hidden_layers"]
    # q, k, v, out; fc1, fc2; QK^T and PV over all T x T (the plain form)
    per_layer = 2 * (4 * T * H * H + 2 * T * H * inter + 2 * T * T * H)
    assert request_flops(cfg, point)["text_encoder"] == 2 * L * per_layer


def test_vae_decode_operations_by_hand():
    cfg = _tiny("tiny_sd")
    point = _tiny("tiny_sd.image")["point"]
    # tiny VAE: latents 8x8x4 -> 16x16x3; blocks (8, 16), one resnet a block + 1
    conv = lambda cin, cout, k, hw: 2 * cin * cout * k * k * hw
    hw0, hw1 = 8 * 8, 16 * 16
    f = conv(4, 4, 1, hw0) + conv(4, 16, 3, hw0)
    res = lambda c, hw: 2 * conv(c, c, 3, hw)
    f += 2 * res(16, hw0)                                   # mid resnets
    f += 4 * 2 * hw0 * 16 * 16 + 2 * 2 * hw0 * hw0 * 16     # mid attention: 4 linears, QK, PV
    f += 2 * res(16, hw0) + conv(16, 16, 3, hw1)            # up_0: 2 resnets, upsample conv
    f += conv(16, 8, 3, hw1) + conv(8, 8, 3, hw1) + conv(16, 8, 1, hw1)   # up_1 res_0
    f += res(8, hw1) + conv(8, 3, 3, hw1)                   # up_1 res_1, conv_out
    assert request_flops(cfg, point)["vae_decode"] == f


@pytest.mark.parametrize("cell,unet_call,vae", [
    ("zeroscope_576w.video", 27.9e12, 28.2e12),
    ("sd15.image", 1.60e12, 2.51e12),
])
def test_full_size_counts_agree_with_the_meta_device_counts_of_the_port(cell, unet_call, vae):
    """PERF.md's counts over the port's own modules (torch.utils.flop_counter
    on the meta device), which this count does not use."""
    wl = cells.load_workload(cell)
    got = request_flops(cells.load_config(wl["config"]), wl["point"])
    assert got["unet_call"] == pytest.approx(unet_call, rel=0.01)
    assert got["vae_decode"] == pytest.approx(vae, rel=0.01)
    assert got["total"] == got["text_encoder"] + 40 * got["unet_call"] + got["vae_decode"]
