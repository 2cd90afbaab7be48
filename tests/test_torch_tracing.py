"""The program's spans and launch records (``common/profiler.py``): the span
tree of a tagged answer through ``SpiderDecoder.generate`` on the tiny SD and
VD pipelines, of a story answer through ``SpiderDecoderInfer`` on the tiny
SDXL beside an image answer's, recording off, many threads at once, the clock the spans are
put on against torch.profiler's, and launch shapes kept under the open span
(the card's side: ``test_torch_tracing_cuda.py``)."""

import collections
import functools
import sys
import threading

import pytest
import torch

from spider_tpu_torch.common import profiler as P
from spider_tpu_torch.ops import launch

STEPS = 3


@pytest.fixture(autouse=True)
def _fresh():
    P.drain()
    yield
    P.drain()


def _tiny_decoder(modality):
    from spider_tpu_torch.models.spider_decoder import SpiderDecoder
    from spider_tpu_torch.spider_decoder_infer import build_default_decoders

    fn = build_default_decoders(tiny=True, with_grounding=False,
                                device=torch.device("cpu"))[modality]

    def few_steps(prompts, **kw):
        return fn(prompts, **{**kw, "num_inference_steps": STEPS})

    return SpiderDecoder(decoders={modality: few_steps})


def _generate(decoder, modality):
    from spider_tpu_torch.models.spider_decoder import (empty_predictions,
                                                        empty_predictions_text)

    preds = empty_predictions()
    decoder.generate({"llm_text_all": [f"Here. <{modality}>a red fox</{modality}>"]}, [],
                     preds, empty_predictions_text())
    return preds


def _children(spans):
    kids = collections.defaultdict(list)
    for s in spans:
        kids[s.parent].append(s)
    for v in kids.values():
        v.sort(key=lambda s: s.start_ns)
    return kids


@pytest.mark.parametrize("modality", ["IMAGE", "VIDEO"])
def test_span_tree_of_a_tagged_answer(modality):
    decoder = _tiny_decoder(modality)
    with P.recording():
        preds = _generate(decoder, modality)
    rec = P.drain()
    assert len(preds[modality]) == 1
    kids = _children(rec.spans)
    (root,) = kids[None]
    assert root.name == "decoder.request" and root.root == root.id
    assert all(s.root == root.id for s in rec.spans)
    (dispatch,) = kids[root.id]
    assert dispatch.name == "decoder.dispatch" and dispatch.attrs == {"modality": modality}
    assert [s.name for s in kids[dispatch.id]] == [
        "pipeline.text_encode", "pipeline.text_encode", "pipeline.denoise",
        "pipeline.vae_decode"]
    denoise = kids[dispatch.id][2]
    steps = kids[denoise.id]
    assert [(s.name, s.attrs) for s in steps] == [("pipeline.step", {"i": i})
                                                 for i in range(STEPS)]
    levels = 2                                     # the tiny UNets' block levels
    blocks = ([f"unet.down_{i}" for i in range(levels)] + ["unet.mid"]
              + [f"unet.up_{i}" for i in range(levels)])
    for step in steps:
        (unet,) = kids[step.id]
        assert unet.name == "unet"
        assert [s.name for s in kids[unet.id]] == blocks
    by_id = {s.id: s for s in rec.spans}
    for s in rec.spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    assert len(rec.spans) == 6 + STEPS * (2 + 2 * levels + 1)


STORY = ("Once. <IMAGESTORY><GENERALPROMPT>'a fox'</GENERALPROMPT>, <PROMPTARRAY>['wakes up', "
         "'finds a map', 'sails', 'lands', 'sleeps']</PROMPTARRAY>, <STYLENAME>'Comic book'"
         "</STYLENAME></IMAGESTORY>")


def test_a_story_request_is_one_tree_and_an_image_request_keeps_its_spans():
    """Through ``SpiderDecoderInfer``: a story answer records one
    ``decoder.request`` root, one IMAGESTORY ``decoder.dispatch``, the four
    pipeline spans and one ``unet.story_attn`` (with its ``story_attention``
    launch record) a consistent transformer layer; an image answer records
    the span names and counts ``SpiderDecoder.generate`` records."""
    from spider_tpu_torch.common.config import Config
    from spider_tpu_torch.models.pipelines.sdxl_story import build_tiny_sdxl, story_generation
    from spider_tpu_torch.models.spider_decoder import SpiderDecoderInfer

    pipe = build_tiny_sdxl(device=torch.device("cpu"))
    story_fn = functools.partial(story_generation, pipe, id_length=4, sa_ratio=0.5,
                                 num_inference_steps=STEPS, height=16, width=16)
    image = _tiny_decoder("IMAGE")
    infer = SpiderDecoderInfer(Config.fromdict(dict(model=dict(type="spider_decoder"))),
                               decoders=image.decoders, story_fn=story_fn)
    with P.recording():
        _, preds, _ = infer({"llm_text_all": [STORY]})
    rec = P.drain()
    assert len(preds["IMAGESTORY"][0]) == 5
    kids = _children(rec.spans)
    (root,) = kids[None]
    assert root.name == "decoder.request" and all(s.root == root.id for s in rec.spans)
    (dispatch,) = kids[root.id]
    assert dispatch.name == "decoder.dispatch" and dispatch.attrs == {"modality": "IMAGESTORY"}
    assert [s.name for s in kids[dispatch.id]] == [
        "pipeline.text_encode", "pipeline.text_encode", "pipeline.denoise",
        "pipeline.vae_decode"]
    steps = kids[kids[dispatch.id][2].id]
    assert [(s.name, s.attrs) for s in steps] == [("pipeline.step", {"i": i})
                                                 for i in range(STEPS)]
    layers = 2                   # a tiny up level: 2 transformers of depth 1, each consistent
    for step in steps:
        (unet,) = kids[step.id]
        levels = {s.name: s for s in kids[unet.id]}
        assert list(levels) == ["unet.down_0", "unet.down_1", "unet.mid", "unet.up_0",
                                "unet.up_1"]
        for name, level in levels.items():
            story_attn = [s for s in kids[level.id] if s.name == "unet.story_attn"]
            assert len(story_attn) == (layers if name.startswith("unet.up") else 0)
    attn = [s for s in rec.spans if s.name == "unet.story_attn"]
    assert len(attn) == 2 * layers * STEPS
    assert [r.span for r in rec.launches if r.kernel == "story_attention"] == [s.id for s in attn]
    assert {(r.route, r.shape["T"], r.shape["K"]) for r in rec.launches} == {
        ("split", 16, 32), ("split", 64, 128)}

    names = []
    for run_image in (lambda: infer({"llm_text_all": ["Here. <IMAGE>a red fox</IMAGE>"]}),
                      lambda: _generate(image, "IMAGE")):
        with P.recording():
            run_image()
        names.append(collections.Counter(s.name for s in P.drain().spans))
    assert names[0] == names[1] and "unet.story_attn" not in names[0]
    assert sum(names[0].values()) == 6 + STEPS * (2 + 2 * 2 + 1)


def test_recording_off_records_nothing():
    assert not P.recording_on()
    assert P.span("unet") is P.NO_SPAN and P.span("x", i=1) is P.NO_SPAN
    with P.span("unet") as s:
        assert s is None
    _generate(_tiny_decoder("IMAGE"), "IMAGE")
    rec = P.drain()
    assert rec.spans == [] and rec.launches == []


def test_recording_restores_its_state_and_drain_empties():
    with P.recording():
        with P.recording():
            with P.span("a"):
                pass
        assert P.recording_on()
        with P.span("b"):
            pass
    assert not P.recording_on()
    assert [s.name for s in P.drain().spans] == ["a", "b"]
    assert P.drain().spans == []


def test_threads_lose_no_span_and_parent_on_their_own_thread():
    threads, per = 8, 1000
    barrier = threading.Barrier(threads)

    def work():
        barrier.wait(timeout=30)
        with P.span("outer"):
            for i in range(per - 1):
                with P.span("inner", i=i):
                    pass

    pool = [threading.Thread(target=work) for _ in range(threads)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with P.recording():
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in pool)
    spans = P.drain().spans
    assert len(spans) == threads * per
    assert len({s.id for s in spans}) == threads * per
    by_id = {s.id: s for s in spans}
    outers = [s for s in spans if s.name == "outer"]
    assert len(outers) == threads and all(s.parent is None for s in outers)
    assert len({s.thread for s in outers}) == threads
    for s in spans:
        if s.name == "inner":
            parent = by_id[s.parent]
            assert parent.name == "outer" and parent.thread == s.thread
            assert s.root == parent.id


def test_a_record_function_inside_a_span_falls_inside_its_converted_interval():
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof, P.recording():
        with P.span("outer.span"):
            with record_function("inner.region"):
                torch.ones(32, 32) @ torch.ones(32, 32)
    rec = P.drain()
    (outer,) = rec.spans
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    inner = events["inner.region"]
    assert rec.wall_ns(outer.start_ns) <= inner.start_ns()
    assert inner.start_ns() + inner.duration_ns() <= rec.wall_ns(outer.end_ns)
    # the span is a row of the trace too, opened with it
    row = events["outer.span"]
    assert row.start_ns() <= inner.start_ns()
    assert abs(row.start_ns() - rec.wall_ns(outer.start_ns)) < 50e6


def test_count_launch_keeps_the_shape_under_the_open_span():
    def wrapper():
        pass

    wrapper.launches, wrapper.route_launches = 0, {"r": 0}
    shape = dict(B=2, T=8, S=8, Hq=2, Hkv=2, D=16, causal=False, elem_bytes=2)
    launch.count_launch(wrapper, "r", shape)          # not recording: counted only
    with P.recording():
        launch.count_launch(wrapper, "r")              # no shape: counted only
        with P.span("unet") as outer:
            with P.span("unet.mid") as mid:
                launch.count_launch(wrapper, "r", shape)
            launch.count_launch(wrapper, "r", dict(shape, T=16))
        launch.count_launch(wrapper, "r", dict(shape, T=32))
    rec = P.drain()
    assert wrapper.launches == 5 and wrapper.route_launches == {"r": 5}
    assert [(r.kernel, r.route, r.shape["T"], r.span) for r in rec.launches] == [
        ("wrapper", "r", 8, mid.id), ("wrapper", "r", 16, outer.id), ("wrapper", "r", 32, None)]
    assert rec.launches[0].shape == shape
    assert mid.start_ns <= rec.launches[0].t_ns <= mid.end_ns
