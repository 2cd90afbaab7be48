"""The story cell's loop (``loops/story.py``) end to end on the CPU at the
tiny size: sound, it comes out correct; with the program broken underneath,
correct comes out false under each fault (the noise changed, the bank
dropped, the bank indices drawn again), and the fp8 control fails the
limits. ``request_flops`` counts the bank; a traced run holds the program's
``unet.story_attn`` spans and ``story_attention`` launches; the readers of
``story_roofline.py`` on a synthetic request."""

import contextlib
import json
import os
import types

import numpy as np
import pytest
import torch

from benchmark import cells, profiling as P, roofline, run, story_roofline
from benchmark.loops import story as S
from spider_tpu_torch.common.profiler import LaunchRecord, Recording, SpanRecord

DATA = os.path.join(os.path.dirname(__file__), "data")


def _tiny(name):
    with open(os.path.join(DATA, name + ".json")) as f:
        return json.load(f)


WL, CFG = _tiny("tiny_sdxl.story"), _tiny("tiny_sdxl")


def _noise_changed(pipe):
    """Initial latents from another seed than the story's (the bank indices
    still from the story's)."""
    base = type(pipe)

    class OtherNoise(base):
        def __call__(self, *a, seed=0, **kw):
            gen = torch.Generator(device=self.device).manual_seed(seed + 1)
            return base.__call__(self, *a, seed=seed, generator=gen, **kw)

    pipe.__class__ = OtherNoise


def _indices_drawn_again(pipe):
    draw = pipe._story_indices

    def other(id_length, lat_hw, sa_ratio, rng):
        return draw(id_length, lat_hw, sa_ratio, np.random.default_rng(int(rng.integers(2 ** 62))))

    pipe._story_indices = other


FAULTS = {None: lambda pipe: None, "noise_changed": _noise_changed,
          "bank_dropped": lambda pipe: None, "indices_drawn_again": _indices_drawn_again}


def _build(fault=None):
    from spider_tpu_torch.models.pipelines.sdxl_story import build_tiny_sdxl

    def build(config, device):
        pipe = build_tiny_sdxl(device=device)
        FAULTS[fault](pipe)
        return pipe

    return build


def _bench(names=()):
    """BENCHMARK.json with the tiny cell added to the workloads of `names`."""
    bench = cells.load_benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in names:
            m["workloads"] = m["workloads"] + [WL["name"]]
    return bench


def _execute(fault, monkeypatch, capsys, trace=0, bench=None, seed=2 ** 33 + 41):
    """run.execute on the tiny story cell on the CPU; -> (its result line,
    the Run its metrics were read from)."""
    from spider_tpu_torch.models.unet2d import story_bank_config

    kept = []

    class Kept(run.Run):
        def __init__(self, **k):
            super().__init__(**k)
            kept.append(self)

    monkeypatch.setattr(run, "Run", Kept)
    args = types.SimpleNamespace(workload=WL["name"], seed=seed, seconds=0.5, trace=trace,
                                 cell_kwargs=dict(build=_build(fault)))
    with contextlib.ExitStack() as stack:
        if fault == "bank_dropped":
            stack.enter_context(story_bank_config("self_only"))
        assert run.execute(args, bench or cells.load_benchmark(), WL, CFG, S,
                           torch.device("cpu")) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1]), kept[-1]


@pytest.mark.parametrize("fault,fails", [
    (None, set()), ("noise_changed", {"noise_max_abs"}),
    ("bank_dropped", {"bank_rel_l2", "unet_rel_l2"}),
    ("indices_drawn_again", {"bank_rel_l2", "unet_rel_l2"}),
])
def test_correct_comes_out_false_under_each_fault(fault, fails, monkeypatch, capsys):
    result, _ = _execute(fault, monkeypatch, capsys)
    assert result["correct"] is (fault is None), result["checks"]
    assert list(result["checks"]) == list(S.CHECK_NAMES) and result["attempted"] >= 1
    failing = {n for n, c in result["checks"].items() if c["value"] > c["limit"]}
    assert failing == fails


def test_the_fp8_control_fails_the_limits():
    for seed in (21, 22):
        cell = S.Cell(WL, CFG, seed, torch.device("cpu"), build=_build())
        cell.serve(0)
        records = S.records_of(cell, [0])
        assert records[0]["attn"].keys() == set(S.bank_paths(CFG, WL["point"]))
        ref = S.reference_for(cell)
        sound = S.program_numbers(ref, records)
        ctrl = S.control_numbers(ref, records)
        limits = WL["check"]["limits"]
        assert all(sound[n] <= limits[n] for n in limits)
        assert {n for n, v in ctrl.items() if v > limits[n]} == set(ctrl)


def test_the_answer_is_one_story_in_the_system_prompts_grammar():
    from spider_tpu_torch.models import tags

    pool = [f"caption {i}" for i in range(20)]
    text, (general, scenes, style) = S.answer(WL, pool, 2 ** 40 + 1, 3)
    assert S.answer(WL, pool, 2 ** 40 + 1, 3)[0] == text != S.answer(WL, pool, 2 ** 40 + 1, 4)[0]
    assert tags.get_llm_text_modality(text, list(tags.MODALITY_KEYS)) == ["IMAGESTORY"]
    assert tags.extract_story_elements(text) == (general, scenes, style)
    assert len(scenes) == WL["point"]["frames"] and style in tags.STYLE_NAMES


def _bank_work(config, point, B, g):
    """Operations the bank adds to one UNet call: in each consistent block,
    QK^T and PV of every row over the K bank keys, and the bank's k and v
    projected once a group."""
    cfg = config["unet_as_run"]
    h, w = S.latent_hw(config, point)
    n, total = len(cfg["block_out_channels"]), 0
    for path, idx in S.bank_indices(config, point, 0).items():
        level = n - 1 - int(path.split("_")[1])
        C, K = cfg["block_out_channels"][level], len(idx)
        T = (h // 2 ** level) * (w // 2 ** level)
        total += cfg["transformer_layers_per_block"][level] * (4 * B * T * K * C + 4 * g * K * C * C)
    return total


def test_request_flops_counts_the_bank():
    point = WL["point"]
    with_bank = S.request_flops(CFG, point)
    without = S.request_flops(CFG, dict(point, id_length=0))
    B = 2 * point["frames"]
    assert with_bank["unet_call"] - without["unet_call"] == _bank_work(CFG, point, B, 2) > 0
    assert with_bank["unet"] == point["num_inference_steps"] * with_bank["unet_call"]
    assert with_bank["total"] == sum(with_bank[k] for k in ("text_encoder", "unet", "vae_decode"))
    assert with_bank["text_encoder"] == without["text_encoder"] > 0


def test_a_traced_run_records_story_attn_spans_and_launches(monkeypatch, capsys):
    bench = _bench({"image_request_s", "mfu.story", "unet_host_ms.image", "story_attn_ms.story",
                    "story_attn_roofline.story"})
    result, r = _execute(None, monkeypatch, capsys, trace=1, bench=bench, seed=2 ** 33 + 43)
    assert result["correct"] and result["failed"] == 0
    assert {"mfu.story", "unet_host_ms.image"} <= set(result["metrics"])
    steps = WL["point"]["num_inference_steps"]
    layers = 4                               # 2 up levels x 2 transformers x depth 1
    recs = r.window["program_spans"]
    assert recs and -1 not in recs
    for i, rec in recs.items():
        names = [s[0] for s in rec.spans]
        assert names.count("decoder.request") == 1 and names.count("unet") == steps
        assert names.count("unet.story_attn") == layers * steps, i
        shapes = rec.launches["story_attention"]
        assert len(shapes) == layers * steps
        assert {(s["T"], s["K"], s["D"]) for s in shapes} == {(16, 32, 16), (64, 128, 8)}
        assert all(s["B"] == 10 and s["g"] == 2 and s["heads"] == 2 and s["elem_bytes"] == 4
                   for s in shapes)


def test_story_attention_cost_by_hand():
    moved, ops = story_roofline.story_attention_cost(B=4, g=2, T=8, K=6, heads=2, D=16,
                                                     elem_bytes=2)
    assert moved == 2 * (4 * 4 * 8 * 32 + 2 * 2 * 6 * 32)
    assert ops == 4 * 32 * 4 * 8 * (8 + 6)


MS = 1_000_000
ANCHOR = (5 * MS, 1_000_000 * MS)
SHAPE = dict(B=10, g=2, T=2304, K=4608, heads=10, D=64, elem_bytes=2)


def _synthetic():
    """Two UNet calls, each holding one ``unet.story_attn`` span with one
    launch record; device operations launched in the attention spans (3 ms
    and 1 ms) and in the UNet outside them (5 ms)."""
    def span(sid, name, parent, a, b):
        return SpanRecord(name, sid, parent, 1, 7, {}, a * MS + ANCHOR[0], b * MS + ANCHOR[0])

    spans = [span(1, "decoder.request", None, 0, 100), span(2, "unet", 1, 10, 40),
             span(3, "unet.story_attn", 2, 20, 30), span(4, "unet", 1, 50, 80),
             span(5, "unet.story_attn", 4, 60, 70)]
    launches = [LaunchRecord("story_attention", "split", dict(SHAPE), sid, 0) for sid in (3, 5)]
    rec = P.compact(Recording(spans, launches, ANCHOR))
    wall = lambda ms: ANCHOR[1] + ms * MS
    sl = P.Slice("cpu")
    sl.ops = [("flash_fwd", wall(21), wall(23), wall(21)), ("merge", wall(23), wall(24), wall(22)),
              ("gemm", wall(31), wall(36), wall(31)), ("flash_fwd", wall(61), wall(62), wall(61))]
    sl.t0_ns, sl.t1_ns, sl.wall_s = ANCHOR[0], ANCHOR[0] + 100 * MS, 0.1
    return types.SimpleNamespace(window=dict(profiled=0, program_spans={0: rec}), slice=sl)


def test_the_story_attention_readers_on_a_synthetic_request():
    r = _synthetic()
    assert story_roofline.story_attn_ms(r) == pytest.approx(2.0)     # 4 ms over 2 calls
    least = 2 * roofline.bound_s(*story_roofline.story_attention_cost(**SHAPE))
    assert story_roofline.story_attn_roofline(r) == pytest.approx(100 * least / 4e-3)
    r.window["program_spans"][0] = P.compact(Recording([], [], ANCHOR))
    assert story_roofline.story_attn_ms(r) is None
    assert story_roofline.story_attn_roofline(r) is None
