"""The port's story pipeline behind its entry points, on the CPU at tiny
widths: the story entry twin (spider_tpu_torch/story_diffusion_infer.py) on
--device cpu against the root JAX script (the same arguments give as many
frames, of the same shape; without --device it needs CUDA), and
``functools.partial(story_generation, pipe, ...)`` as the ``story_fn`` of
SpiderFree (streamed events and the HTTP server's JSON), SpiderDecoderInfer
and SpiderInference, rendering an IMAGESTORY span."""

import base64
import functools
import io
import json
import os
import sys
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from spider_tpu_torch.common.config import Config
from spider_tpu_torch.models.pipelines.sdxl_story import build_tiny_sdxl, story_generation

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "train_configs", "spider_decoder_cfg.py")
SPAN = ("<IMAGESTORY><GENERALPROMPT>a fox</GENERALPROMPT>"
        "<PROMPTARRAY>['wakes up', 'finds a map', 'sails home']</PROMPTARRAY>"
        "<STYLENAME>Comic book</STYLENAME></IMAGESTORY>")


@pytest.fixture(scope="module")
def story_fn():
    """The serving wiring of the story pipeline (id_length 4, sa_ratio 0.5
    at full size), at the tiny pipeline's 16 px and 2 steps, 2 id images."""
    return functools.partial(story_generation, build_tiny_sdxl(device="cpu"), id_length=2,
                             sa_ratio=0.5, num_inference_steps=2, height=16, width=16)


def _frames_ok(frames, n=3):
    assert len(frames) == n
    for f in frames:
        assert f.shape == (16, 16, 3) and 0.0 <= f.min() and f.max() <= 1.0


def test_spider_free_renders_the_story_span(story_fn):
    from spider_tpu_torch.serving import http_server
    from spider_tpu_torch.serving.spider_free import SpiderFree

    sf = SpiderFree(Config.fromfile(CFG), chat_fn=lambda p: "Here is your story. " + SPAN,
                    story_fn=story_fn)
    events, answers, predictions, texts = sf.chat("Tell me a story.")
    assert [k for k, _ in events] == ["text", "story"]
    _frames_ok(events[1][1]["images"])
    assert texts["IMAGESTORY_prompts"] == [["wakes up", "finds a map", "sails home"]]
    server = http_server.serve(sf, port=0, background=True)
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/chat",
            data=json.dumps({"text": "Tell me a story.", "stream": False}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
    story = [e for e in out["events"] if e["kind"] == "story"]
    assert len(story) == 1 and len(story[0]["data"]) == 3
    for png in story[0]["data"]:
        assert np.asarray(Image.open(io.BytesIO(base64.b64decode(png)))).shape == (16, 16, 3)


def test_decoder_infer_and_inference_render_the_story_span(story_fn):
    from spider_tpu_torch.models.spider_decoder import SpiderDecoderInfer
    from spider_tpu_torch.serving.inference_api import SpiderInference

    infer = SpiderDecoderInfer(Config.fromdict(dict(model=dict(type="spider_decoder"))),
                               decoders={}, story_fn=story_fn)
    _, predictions, texts = infer({"llm_text_all": [SPAN]})
    _frames_ok(predictions["IMAGESTORY"][0])
    assert texts["IMAGESTORY_prompts"] == [["wakes up", "finds a map", "sails home"]]

    class StubModel:
        def generate(self, samples, answers, predictions, predictions_text, **kw):
            answers.append("Once. " + SPAN)
            return answers, predictions, predictions_text

    res = SpiderInference(Config.fromdict({"model": {"type": "spider"}, "run": {}}),
                          model=StubModel(), story_fn=story_fn)({"Question": ["a story"]})
    _frames_ok(res[1]["IMAGESTORY"][0])


def test_story_twin_agrees_with_the_root_script(capsys, monkeypatch):
    from spider_tpu_torch import story_diffusion_infer as twin

    frames = twin.main(["a fox explorer", "wakes up|finds a map|sails home", "Comic book",
                        "--device", "cpu"])
    out = capsys.readouterr().out
    assert out == f"generated {len(frames)} frames of shape {frames[0].shape}\n"
    monkeypatch.setattr(sys, "argv", ["story_diffusion_infer.py", "a fox explorer",
                                      "wakes up|finds a map|sails home", "Comic book"])
    sys.path.insert(0, ROOT)
    try:
        root = __import__("story_diffusion_infer")
    finally:
        sys.path.remove(ROOT)
    root.main()
    assert capsys.readouterr().out == out        # as many frames, of the same shape
    assert len(frames) == 3 and frames[0].shape == (16, 16, 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        twin.main([])                          # cuda is the default: it never falls back
