"""The serving stack around SpiderFree: the stage orchestrator and the HTTP
server held to the JAX package's, and the launch counter the kernel wrappers
share, under threads.

The decoders are stubs returning seeded numpy media (the same arrays for
both packages), so what is compared is the orchestration and the wire
format: events, their order, and the bodies the two servers send, byte for
byte where the encoders are the same code.
"""

import base64
import io
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest
import torch

from spider_tpu.common.config import Config as JaxConfig
from spider_tpu.serving import http_server as jhttp
from spider_tpu.serving import orchestrator as jorch
from spider_tpu.serving import spider_free as jsf
from spider_tpu_torch.common.config import Config
from spider_tpu_torch.ops import launch
from spider_tpu_torch.serving import http_server as thttp
from spider_tpu_torch.serving import orchestrator as torch_orch
from spider_tpu_torch.serving import spider_free as tsf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "train_configs", "spider_decoder_cfg.py")


# ---------------------------------------------------------------------------
# the launch counter
# ---------------------------------------------------------------------------

def test_count_launch_is_exact_under_threads():
    def wrapper():
        pass

    wrapper.launches = 0
    wrapper.route_launches = {"a": 0, "b": 0}
    threads, per = 16, 5000

    def hammer(i):
        for _ in range(per):
            launch.count_launch(wrapper, "a" if i % 2 else "b")

    pool = [threading.Thread(target=hammer, args=(i,)) for i in range(threads)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)          # switch threads as often as possible
    try:
        for t in pool:
            t.start()
        for t in pool:
            t.join()
    finally:
        sys.setswitchinterval(switch)
    assert wrapper.launches == threads * per
    assert wrapper.route_launches == {"a": threads * per // 2, "b": threads * per // 2}
    launch.reset_launches(wrapper)
    assert wrapper.launches == 0 and wrapper.route_launches == {"a": 0, "b": 0}


def test_every_kernel_wrapper_counts_through_the_helper():
    # No wrapper keeps a bare read-modify-write of its count.
    import re

    from spider_tpu_torch.ops import attention, paged_attention, quant, temporal_attention

    for mod in (attention, paged_attention, quant, temporal_attention):
        src = open(mod.__file__).read()
        assert not re.search(r"\.(route_)?launches(\[[^]]*\])?\s*\+=", src), mod.__name__
        assert "count_launch(" in src, mod.__name__


# ---------------------------------------------------------------------------
# the stage orchestrator
# ---------------------------------------------------------------------------

def _media(modality, cap):
    rng = np.random.default_rng(len(cap) + len(modality))
    if modality == "VIDEO":
        return rng.integers(0, 255, (1, 2, 4, 4, 3), dtype=np.uint8)
    if modality == "AUDIO":
        return rng.uniform(-1, 1, (1, 32)).astype(np.float32)
    return rng.uniform(0, 1, (1, 4, 4, 3)).astype(np.float32)


class StubDecoder:
    """decode_modality as SpiderDecoder has it: modality -> fn(samples)."""

    def __init__(self, modalities=("IMAGE", "VIDEO", "AUDIO"), sleep=0.0):
        def fn(m):
            def run(s):
                time.sleep(sleep)
                return _media(m, s["llm_text_res"][0])
            return run

        self.decode_modality = {m: fn(m) for m in modalities}


ANSWER = ("Sure.<IMAGE>a cat</IMAGE><AUDIO>a meow</AUDIO><VIDEO>a cat runs</VIDEO>"
          "<IMAGE>a dog</IMAGE><BOX>the cat</BOX>"
          "<IMAGESTORY><GENERALPROMPT>x</GENERALPROMPT></IMAGESTORY>")


def _events_equal(a, b):
    assert [(m, t) for m, t, _ in a] == [(m, t) for m, t, _ in b]
    for (_, _, x), (_, _, y) in zip(a, b):
        assert (x is None) == (y is None)
        if x is not None:
            np.testing.assert_array_equal(x, y)


def test_run_request_concurrent_matches_jax():
    samples = {"llm_text_all": [ANSWER]}
    dec = StubDecoder(("IMAGE", "VIDEO", "AUDIO", "IMAGESTORY"))
    t_orch = torch_orch.StageOrchestrator({m: None for m in ("IMAGE", "VIDEO", "AUDIO")})
    j_orch = jorch.StageOrchestrator({m: None for m in ("IMAGE", "VIDEO", "AUDIO")})
    try:
        tev, tdone = torch_orch.run_request_concurrent(dec, samples, t_orch)
        jev, jdone = jorch.run_request_concurrent(dec, samples, j_orch)
    finally:
        t_orch.shutdown()
        j_orch.shutdown()
    _events_equal(tev, jev)
    # parse order by modality; IMAGESTORY inline with no media; BOX (no
    # decoder here) dropped
    assert [m for m, _, _ in tev] == ["IMAGE", "IMAGE", "VIDEO", "AUDIO", "IMAGESTORY"]
    assert tev[-1][2] is None
    assert set(tdone) == set(jdone) == {"IMAGE", "VIDEO", "AUDIO"}


def test_stages_overlap():
    samples = {"llm_text_all": ["<IMAGE>a</IMAGE><VIDEO>b</VIDEO><AUDIO>c</AUDIO>"]}
    dec = StubDecoder(sleep=0.3)
    orch = torch_orch.StageOrchestrator(dec.decode_modality)
    try:
        t0 = time.perf_counter()
        events, done = torch_orch.run_request_concurrent(dec, samples, orch)
        seconds = time.perf_counter() - t0
    finally:
        orch.shutdown()
    assert len(events) == 3 and seconds < 0.6          # not 0.9: the three overlap
    assert max(done.values()) < 0.6


def test_dryrun_concurrent_on_the_cpu():
    calls = []

    def stage(m):
        def fn(s):
            calls.append(m)
            return _media(m, s["llm_text_res"][0])
        return fn

    stats = torch_orch.dryrun_concurrent(
        {m: stage(m) for m in ("IMAGE", "VIDEO", "AUDIO")}, device="cpu", repeats=2)
    assert stats["stages"] == 3 and stats["serial_s"] > 0 and stats["concurrent_s"] > 0
    assert stats["overlap_x"] == stats["serial_s"] / stats["concurrent_s"]
    assert [m for m, _, _ in stats["events"]] == ["IMAGE", "VIDEO", "AUDIO"]
    for m, cap, media in stats["events"]:
        np.testing.assert_array_equal(media, _media(m, cap))
    _events_equal(stats["serial_events"], stats["events"])
    assert set(stats["stage_s"]) == {"IMAGE", "VIDEO", "AUDIO"}
    assert len(calls) == 3 * (2 + 2)            # the serial runs, then the concurrent ones


def test_dryrun_concurrent_tiny_pipelines_give_the_serial_media():
    # The tiny SD / ZeroScope / AudioLDM stages on the CPU: the concurrent
    # media equal the serial ones, bit for bit.
    stats = torch_orch.dryrun_concurrent(device="cpu", repeats=1)
    assert [m for m, _, _ in stats["events"]] == ["IMAGE", "VIDEO", "AUDIO"]
    _events_equal(stats["serial_events"], stats["events"])
    shapes = {m: media.shape for m, _, media in stats["events"]}
    assert shapes["VIDEO"] == (1, 4, 32, 32, 3) and shapes["IMAGE"][0] == 1


# ---------------------------------------------------------------------------
# the HTTP server
# ---------------------------------------------------------------------------

def _png(arr):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _wav(pcm, rate=16000):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.astype("<i2").tobytes())
    return base64.b64encode(buf.getvalue()).decode()


def _decode_png(b64):
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


@pytest.mark.parametrize("kind", ["image", "image_u8", "mask", "audio", "video5", "video4",
                                  "story", "box", "other"])
def test_serialize_event_matches_jax(kind):
    rng = np.random.default_rng(3)
    payloads = {
        "image": ("image", dict(media=rng.uniform(-0.2, 1.2, (6, 5, 3)).astype(np.float32),
                                caption="a cat")),
        "image_u8": ("image", rng.integers(0, 255, (6, 5, 3), dtype=np.uint8)),
        "mask": ("mask", dict(media=rng.uniform(0, 1, (6, 5)).astype(np.float32))),
        "audio": ("audio", dict(media=rng.uniform(-1.5, 1.5, (1, 40)).astype(np.float32))),
        "video5": ("video", dict(media=rng.integers(0, 255, (1, 3, 4, 6, 3), dtype=np.uint8))),
        "video4": ("video", rng.uniform(0, 1, (2, 4, 6, 3)).astype(np.float32)),
        "story": ("story", dict(images=[rng.integers(0, 255, (4, 4, 3), dtype=np.uint8)] * 2)),
        "box": ("box", dict(bboxes=[[1, 2, 3, 4]], labels=["cat"], scores=[0.5])),
        "other": ("note", 42),
    }
    k, payload = payloads[kind]
    got, want = thttp.serialize_event(k, payload), jhttp.serialize_event(k, payload)
    assert got == want
    if kind == "image":       # the pixels survive the round trip
        img = _decode_png(got["data"])
        want_px = (np.clip(payload["media"], 0, 1) * 255).astype(np.uint8)
        np.testing.assert_array_equal(img, want_px)


def test_build_ask_info_and_decode_mm_inputs_match_jax():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 255, (20, 30, 3), dtype=np.uint8)
    frames = [rng.integers(0, 255, (8, 8, 3), dtype=np.uint8) for _ in range(3)]
    pcm = rng.integers(-30000, 30000, 400).astype(np.int16)
    req = {"image": _png(img), "audio": _wav(pcm), "video_frames": [_png(f) for f in frames]}
    got, want = thttp.build_ask_info(req), jhttp.build_ask_info(req)
    assert set(got) == set(want) == {"Image_ori_array", "IMAGE_SAM", "Meta_info"}
    np.testing.assert_array_equal(got["Image_ori_array"][0], img)
    np.testing.assert_array_equal(got["IMAGE_SAM"][0], want["IMAGE_SAM"][0])
    assert got["Meta_info"] == want["Meta_info"]
    assert thttp.build_ask_info({}) == {}
    ta, ti, tv = thttp.decode_mm_inputs(req)
    ja, ji, jv = jhttp.decode_mm_inputs(req)
    np.testing.assert_array_equal(ta[0], ja[0])
    np.testing.assert_array_equal(ta[0], pcm.astype(np.float32) / 32767.0)
    np.testing.assert_array_equal(ti[0], ji[0])
    np.testing.assert_array_equal(tv[0], jv[0])
    assert tv[0].shape == (3, 8, 8, 3)


def _decoders():
    def dec(m):
        def fn(prompt, **kw):
            return _media(m, prompt)
        return fn
    return {m: dec(m) for m in ("IMAGE", "VIDEO", "AUDIO")}


def _chat_fn(prompt):
    return ("assistant\nHere it is. <IMAGE>a cat</IMAGE> <AUDIO>a meow</AUDIO>"
            " <VIDEO>a cat runs</VIDEO>")


@pytest.fixture(scope="module")
def servers():
    """(port server, JAX server) over the same chat function and decoders."""
    tserver = thttp.serve(tsf.SpiderFree(Config.fromfile(CFG), _chat_fn,
                                         decoders=_decoders()), port=0, background=True)
    jserver = jhttp.serve(jsf.SpiderFree(JaxConfig.fromfile(CFG), _chat_fn,
                                         decoders=_decoders()), port=0, background=True)
    yield tserver, jserver
    for s in (tserver, jserver):
        s.shutdown()
        s.server_close()


def _post(server, body):
    url = f"http://127.0.0.1:{server.server_address[1]}/chat"
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def test_json_round_trip_matches_jax(servers):
    body = {"text": "show me", "task": "SMARTMULTIMODAL"}
    (ts, tt, tb), (js, jt, jb) = _post(servers[0], body), _post(servers[1], body)
    assert ts == js == 200 and tt == jt == "application/json"
    assert tb == jb
    out = json.loads(tb)
    assert out["answer"].startswith("Here it is.")
    assert [e["kind"] for e in out["events"]] == ["image", "video", "audio"]


def test_sse_round_trip_matches_jax(servers):
    body = {"text": "show me", "task": "SMARTMULTIMODAL", "stream": True}
    (ts, tt, tb), (js, jt, jb) = _post(servers[0], body), _post(servers[1], body)
    assert ts == js == 200 and tt == jt == "text/event-stream"
    assert tb == jb
    events = [json.loads(c[len(b"data: "):]) for c in tb.split(b"\n\n") if c]
    assert [e["kind"] for e in events] == ["text", "image", "video", "audio", "done"]
    assert len(events[2]["data"]) == 2          # one PNG a frame


def test_text_only_backbone_with_audio_gives_400_like_jax(servers):
    body = {"text": "hear this", "audio": _wav(np.zeros(16, np.int16))}
    (ts, _, tb), (js, _, jb) = _post(servers[0], body), _post(servers[1], body)
    # the same status and body shape; SpiderFree's message names no Omni
    # model in the port, which has none yet
    assert ts == js == 400 and set(json.loads(tb)) == set(json.loads(jb)) == {"error"}
    assert "text-only" in json.loads(tb)["error"]


def test_a_failing_decoder_ends_the_stream_with_error_and_done():
    def broken(prompt, **kw):
        raise RuntimeError("decoder down")

    bodies = []
    for http, sf, cfg in ((thttp, tsf, Config), (jhttp, jsf, JaxConfig)):
        server = http.serve(sf.SpiderFree(cfg.fromfile(CFG), _chat_fn,
                                          decoders={"IMAGE": broken}), port=0, background=True)
        try:
            bodies.append(_post(server, {"text": "x", "stream": True})[2])
        finally:
            server.shutdown()
            server.server_close()
    assert bodies[0] == bodies[1]
    kinds = [json.loads(c[6:])["kind"] for c in bodies[0].split(b"\n\n") if c]
    assert kinds == ["text", "error", "done"]


def test_get_serves_the_page(servers):
    url = f"http://127.0.0.1:{servers[0].server_address[1]}/"
    with urllib.request.urlopen(url, timeout=30) as r:
        page = r.read()
    assert page == jhttp._PAGE.encode() and b"/chat" in page
