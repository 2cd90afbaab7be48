"""The rest of a run, without the look for a card, at a tiny size on the CPU:
sound, it comes out correct; with the timed path broken underneath, correct
comes out false, once for each fault these cells can have (one chip, so no
exchange between chips). And the control, the reference computed in fp8 in
the program's place, fails the tiny cells' limits."""

import json
import os
import types

import pytest
import torch

from benchmark import cells, check, run
from benchmark.loops import spider_decoder as D

DATA = os.path.join(os.path.dirname(__file__), "data")


def _tiny(name):
    with open(os.path.join(DATA, name + ".json")) as f:
        return json.load(f)


class _Unchanged:
    """A scheduler whose step returns its state unchanged."""

    def __init__(self, sched):
        self.sched = sched

    def __getattr__(self, name):
        return getattr(self.sched, name)

    def step(self, eps, t, sample, *a, **kw):
        return sample


class _HalfBatch:
    """A UNet that runs the second half of its batch and gives that for the
    whole."""

    def __init__(self, unet):
        self.unet = unet

    def __getattr__(self, name):
        return getattr(self.unet, name)

    def __call__(self, x, t, ctx, *a, **kw):
        h = x.shape[0] // 2
        out = self.unet(x[h:], t[h:], ctx[h:], *a, **kw)
        return torch.cat([out, out])


def _alter_answer(pipe):
    decode = pipe._decode_latents

    def altered(latents):
        out = decode(latents).copy()
        out.reshape(-1)[: out.size // 4] = out.max()
        return out

    pipe._decode_latents = altered


FAULTS = {
    None: lambda pipe: None,
    "state_unchanged": lambda pipe: setattr(pipe, "scheduler", _Unchanged(pipe.scheduler)),
    "half_batch": lambda pipe: setattr(pipe, "unet", _HalfBatch(pipe.unet)),
    "answer_altered": _alter_answer,
}


def _execute(cell, fault, capsys, trace=0):
    from spider_tpu_torch.models.pipelines.sd import build_tiny_sd
    from spider_tpu_torch.models.pipelines.vd import build_tiny_vd

    wl = _tiny(cell)
    cfg = _tiny(wl["config"])
    video = wl["modality"] == "VIDEO"

    def build(config, device):
        pipe = build_tiny_vd(device=device) if video else build_tiny_sd(device=device)
        FAULTS[fault](pipe)
        return pipe

    kw = dict(num_inference_steps=3)
    if video:
        kw.update(height=32, width=32, num_frames=4)
    bench = cells.load_benchmark()
    args = types.SimpleNamespace(workload=wl["name"], seed=2 ** 33 + 17, seconds=0.5, trace=trace,
                                 cell_kwargs=dict(build=build, call_kwargs=kw))
    assert run.execute(args, bench, wl, cfg, D, torch.device("cpu")) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell,fault", [
    ("tiny_sd.image", None), ("tiny_sd.image", "state_unchanged"),
    ("tiny_sd.image", "half_batch"), ("tiny_sd.image", "answer_altered"),
    ("tiny_vd.video", None), ("tiny_vd.video", "state_unchanged"),
    ("tiny_vd.video", "half_batch"), ("tiny_vd.video", "answer_altered"),
])
def test_correct_comes_out_false_under_each_fault(cell, fault, capsys):
    result = _execute(cell, fault, capsys)
    assert result["correct"] is (fault is None), result["checks"]
    assert list(result)[-1] == "checks" and result["attempted"] >= 1
    failing = {n for n, c in result["checks"].items() if c["value"] > c["limit"]}
    expected = {None: set(), "state_unchanged": {"ddim_rel"}, "half_batch": {"unet_rel_l2"},
                "answer_altered": {"vae_rel_l2"}}[fault]
    assert expected <= failing


def test_a_traced_run_reports_its_per_layer_metrics_and_is_checked_alike(capsys):
    result = _execute("tiny_sd.image", None, capsys, trace=1)
    assert result["correct"] is True
    assert "busy_s" in result["device"] and "window_s" in result["device"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell", ["tiny_sd.image", "tiny_vd.video"])
def test_the_fp8_control_fails_the_limits(cell):
    from spider_tpu_torch.models.pipelines.sd import build_tiny_sd
    from spider_tpu_torch.models.pipelines.vd import build_tiny_vd

    wl = _tiny(cell)
    cfg = _tiny(wl["config"])
    video = wl["modality"] == "VIDEO"
    build = (lambda c, d: build_tiny_vd(device=d)) if video else (lambda c, d: build_tiny_sd(device=d))
    kw = dict(num_inference_steps=3, **(dict(height=32, width=32, num_frames=4) if video else {}))
    for seed in (21, 22, 23):
        c = D.Cell(wl, cfg, seed, torch.device("cpu"), build=build, call_kwargs=kw)
        c.serve(0)
        records = D.records_of(c, [0])
        ref = D.reference_for(c)
        sound = check.program_numbers(ref, records)
        ctrl = check.control_numbers(ref, records)
        assert check.verdict(sound, wl["check"]["limits"])
        assert not check.verdict(dict(sound, **ctrl), wl["check"]["limits"])
