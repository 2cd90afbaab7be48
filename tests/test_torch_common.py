"""The port's common helpers against the JAX package on the CPU: utils
(``get_cache_path``, ``makedir``, ``is_url``), ``gradcam.get_att_map``
(within 1e-6), observability (the TensorBoard export, ``tree_bytes`` of
tensors, modules and containers, ``HbmBudget``, which reads no device stats
on the CPU), the profiler (a Chrome trace with a recorded span as its region,
``StepTimer``, ``device_memory_stats``), ``BaseTask.save_result`` and
``RunnerBase.model_forward``."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from spider_tpu.common import gradcam as jG
from spider_tpu.common import observability as jO
from spider_tpu.common import utils as jU
from spider_tpu_torch.common import gradcam as tG
from spider_tpu_torch.common import observability as tO
from spider_tpu_torch.common import profiler as tP
from spider_tpu_torch.common import utils as tU


def test_utils_equal_the_jax_copies(tmp_path, monkeypatch):
    monkeypatch.delenv("SPIDER_TPU_CACHE", raising=False)
    assert tU.get_cache_path("a/b") == jU.get_cache_path("a/b")
    assert tU.get_cache_path("x", str(tmp_path)) == os.path.join(str(tmp_path), "x")
    monkeypatch.setenv("SPIDER_TPU_CACHE", str(tmp_path / "c"))
    assert tU.get_cache_path("w.bin") == jU.get_cache_path("w.bin") == str(tmp_path / "c/w.bin")
    path = str(tmp_path / "d" / "e")
    assert tU.makedir(path) == path and os.path.isdir(path) and tU.makedir(path) == path
    for s in ("http://a", "https://b/c", "ftp://d", "/local/file", "httpx"):
        assert tU.is_url(s) == jU.is_url(s)


@pytest.mark.parametrize("blur,overlap", [(True, True), (False, True), (True, False)])
def test_get_att_map_within_1e6_of_the_jax_copy(blur, overlap):
    rng = np.random.default_rng(0)
    img = rng.random((37, 45, 3)).astype(np.float32)
    att = rng.random((7, 9)).astype(np.float32)
    out = tG.get_att_map(img, att, blur=blur, overlap=overlap)
    want = jG.get_att_map(img, att, blur=blur, overlap=overlap)
    assert out.shape == (37, 45, 3)
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tG.normalize(att), jG.normalize(att))


def test_export_tensorboard_writes_every_scalar(tmp_path):
    pytest.importorskip("tensorboard")
    metrics = tmp_path / "metrics.jsonl"
    rows = [dict(step=i + 1, epoch=0, lr=1e-4 * i, loss=2.0 - 0.1 * i, note="x")
            for i in range(5)]
    metrics.write_text("\n".join(json.dumps(r) for r in rows) + "\n\n")
    assert tO.export_tensorboard(str(metrics), str(tmp_path / "tb")) == 5
    assert glob.glob(str(tmp_path / "tb" / "events.out.tfevents.*"))


def test_tree_bytes_of_tensors_modules_and_containers():
    lin = torch.nn.Linear(4, 3)                                   # 15 fp32 values
    bn = torch.nn.BatchNorm1d(3)                                  # 6 fp32 params, 7 buffers
    assert tO.tree_bytes(lin) == 15 * 4
    assert tO.tree_bytes(bn) == 6 * 4 + 6 * 4 + 8
    tied = torch.nn.Sequential(lin, lin)
    assert tO.tree_bytes(tied) == 15 * 4                          # shared parameters once
    half = torch.zeros(10, dtype=torch.bfloat16)
    assert tO.tree_bytes({"a": [half, (lin,)], "b": None}) == 20 + 60
    # numpy trees count as the JAX package counts them, scalars as float32
    tree = {"w": np.zeros((3, 5), np.float16), "b": [np.ones(4, np.int64), 1.5]}
    assert tO.tree_bytes(tree) == jO.tree_bytes(tree) == 30 + 32 + 4


def test_hbm_budget_reports_components_and_no_device_stats_on_the_cpu():
    budget = tO.HbmBudget("cpu")
    assert budget.device_stats() is None
    budget.register("big", torch.zeros(1000, 1000)).register("small", torch.nn.Linear(4, 3))
    logged = []
    out = budget.report(log=lambda fmt, s: logged.append(fmt % s))
    assert out == {"components_gb": {"big": 0.004, "small": 0.0},
                   "registered_total_gb": 0.004, "hbm_in_use_gb": 0.0, "hbm_limit_gb": 0.0}
    assert list(out["components_gb"]) == ["big", "small"]         # largest first
    assert logged and logged[0].startswith("HBM budget: ")


def test_trace_writes_a_chrome_trace_with_the_annotated_region(tmp_path):
    with tP.trace(str(tmp_path / "prof")) as prof, tP.recording():
        with tP.span("spider::data_step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert [s.name for s in tP.drain().spans] == ["spider::data_step"]
    assert os.path.dirname(prof.trace_path) == str(tmp_path / "prof")
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "spider::data_step" for e in events)
    with tP.trace(str(tmp_path / "off"), enabled=False) as off:
        assert off is None
    assert not os.path.exists(tmp_path / "off")


def test_step_timer_and_device_memory_stats(monkeypatch):
    timer = tP.StepTimer(window=3)
    assert timer.summary() == {}
    for _ in range(5):
        with timer.step():
            pass
    s = timer.summary()
    assert len(timer.times) == 3 and set(s) == {"p50", "p90", "mean", "steps_per_s"}
    assert 0 <= s["p50"] <= s["p90"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tP.device_memory_stats() == {}


def test_save_result_merges_as_the_jax_task_does(tmp_path):
    from spider_tpu.tasks.base_task import BaseTask as JTask
    from spider_tpu_torch.tasks.base_task import BaseTask as TTask

    results = [{"loss": 1.5, "id": 3}, {"loss": 0.25, "id": 4}]
    got = TTask().save_result(results, str(tmp_path / "t"), "val_epoch0")
    want = JTask().save_result(results, str(tmp_path / "j"), "val_epoch0")
    assert got == str(tmp_path / "t" / "val_epoch0.json")
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j")) \
        == ["val_epoch0.json", "val_epoch0_rank0.json"]
    with open(got) as f, open(want) as g:
        assert json.load(f) == json.load(g) == results


def test_model_forward_is_the_models_forward():
    from spider_tpu_torch.runners.runner import RunnerBase

    class Model:
        def forward(self, samples):
            return {"loss": torch.tensor(float(len(samples["Question"])))}

    runner = RunnerBase.__new__(RunnerBase)
    runner.model = Model()
    assert float(runner.model_forward({"Question": ["a", "b"]})["loss"]) == 2.0
