"""Parity of the port's Spider inference with the JAX package: ``generate``
(prompt preparation, bucket, prompt length, the greedy decode with its
hidden-state taps, the answer) and ``_decode_modality_infer`` (the signal
run's hidden states through the aligner, fused 0.1 / 0.9 with the decoder's
text conditioning), plus ``SpiderInference`` and ``load_demo_checkpoint``.

Both models are the tiny Spider on the JAX model's weights (through
``convert.load_jax_spider``); inputs are made with numpy from a seed; fp32 on
the CPU. Hidden states and fused conditionings are held to 1e-5 (the same
fp32 arithmetic in another order, through two decoder layers and the
aligner); token ids, prompts and answers are held equal.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spider_tpu.models import factory as jF
from spider_tpu.models import spider as jS
from spider_tpu.models.spider_decoder import empty_predictions as j_empty
from spider_tpu.models.spider_decoder import empty_predictions_text as j_empty_text
from spider_tpu_torch.models import factory as tF
from spider_tpu_torch.models import spider as tS
from spider_tpu_torch.models.convert import load_jax_spider
from spider_tpu_torch.models.spider_decoder import empty_predictions, empty_predictions_text

NEW_TOKENS = 12


def _numpy_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x), tree)


@pytest.fixture(scope="module")
def pair():
    """(JAX Spider, port Spider) on the same weights, the LoRA b matrices
    made non-zero."""
    js = jF.build_tiny_spider(with_pipes=False)
    rng = np.random.default_rng(0)
    tree = _numpy_tree(js.trainable_params())

    def lora_b(path, x):
        if "lora_b" in jax.tree_util.keystr(path):
            return 0.05 * rng.standard_normal(x.shape).astype(np.float32)
        return x

    tree = jax.tree_util.tree_map_with_path(lora_b, tree)
    js.update_params(jax.tree_util.tree_map(jnp.asarray, tree))
    ts = tF.build_tiny_spider(device="cpu", with_pipes=False)
    load_jax_spider(ts, tree, _numpy_tree(js.encoder_params))
    return js, ts


def _samples(with_image: bool, task="IMAGE", B=1, seed=0, pad=True):
    """One request; with an image slot, a prompt of 32 tokens exactly, or
    with pad=True one that the 32-token bucket pads."""
    rng = np.random.default_rng(seed)
    if with_image:
        q = "what is in <IMAGE><IMAGE-Placeholder></IMAGE>? draw it" + ("" if pad else "!!!!!")
        s = {"IMAGE": [rng.standard_normal((3, 2, 28, 28)).astype(np.float32)
                       for _ in range(B)]}
    else:
        q, s = "draw a dog running on the beach", {}
    s.update(Question=[q] * B, TaskPrompt=[f"[{task}]"] * B)
    return s


def _record_generate(monkeypatch, js, ts):
    """Record what each package hands its decode (the prompt ids through
    ``_splice_embeds``, the embeddings, prompt_len, the config) and what the
    decode returns."""
    rec = {"jax": {}, "torch": {}}
    j_gen, t_gen = jS.generate, tS.generate

    def j_recording(model, params, embeds, prompt_len, cfg, rng=None):
        out = j_gen(model, params, embeds, prompt_len, cfg, rng=rng)
        jax.debug.callback(
            lambda e, l, t, h: rec["jax"].update(embeds=np.asarray(e), prompt_len=np.asarray(l),
                                                 tokens=np.asarray(t), step_hidden=np.asarray(h)),
            embeds, prompt_len, out["tokens"], out["step_hidden"])
        rec["jax"]["cfg"] = cfg
        return out

    def t_recording(model, embeds, prompt_len, cfg, generator=None):
        out = t_gen(model, embeds, prompt_len, cfg, generator)
        rec["torch"].update(embeds=embeds.numpy(), prompt_len=prompt_len.numpy(), cfg=cfg,
                            tokens=out["tokens"].numpy(), step_hidden=out["step_hidden"].numpy())
        return out

    j_splice, t_splice = js._splice_embeds, ts._splice_embeds

    def j_splice_rec(llm_params, proj_params, batch, embeds):
        rec["jax"]["prompt_ids"] = np.array(batch.input_ids)
        return j_splice(llm_params, proj_params, batch, embeds)

    def t_splice_rec(batch, embeds):
        rec["torch"]["prompt_ids"] = np.array(batch.input_ids)
        return t_splice(batch, embeds)

    monkeypatch.setattr(jS, "generate", j_recording)
    monkeypatch.setattr(tS, "generate", t_recording)
    monkeypatch.setattr(js, "_splice_embeds", j_splice_rec)
    monkeypatch.setattr(ts, "_splice_embeds", t_splice_rec)
    js._loss_jit_cache.clear()          # the recorder must be traced in
    return rec


@pytest.mark.parametrize("with_image", [False, True], ids=["text_only", "image_slot"])
def test_generate_matches_jax(pair, monkeypatch, with_image):
    # The image-slot prompt fills its bucket exactly: the reference cannot
    # pad a prompt with a slot (ROADMAP C10; the next test).
    js, ts = pair
    rec = _record_generate(monkeypatch, js, ts)
    samples = _samples(with_image, pad=not with_image)
    jout = js.generate(samples, [], j_empty(), j_empty_text(), max_new_tokens=NEW_TOKENS)
    tout = ts.generate(samples, [], empty_predictions(), empty_predictions_text(),
                       max_new_tokens=NEW_TOKENS)
    j, t = rec["jax"], rec["torch"]
    np.testing.assert_array_equal(t["prompt_ids"], j["prompt_ids"])
    assert t["prompt_ids"].shape[1] % 32 == 0                 # the 32-token bucket
    np.testing.assert_array_equal(t["prompt_len"], j["prompt_len"])
    pads = (t["prompt_ids"][0] == ts.tokenizer.pad_token_id).sum()
    if with_image:                       # the slot holds pad_id and is a real position
        assert int(t["prompt_len"][0]) == t["prompt_ids"].shape[1] and pads == 1
    else:
        assert int(t["prompt_len"][0]) == t["prompt_ids"].shape[1] - pads and pads > 0
    np.testing.assert_allclose(t["embeds"], j["embeds"], atol=1e-5, rtol=0)
    for field in ("max_new_tokens", "eos_ids", "pad_id", "collect_layers"):
        assert getattr(t["cfg"], field) == getattr(j["cfg"], field), field
    assert t["cfg"].eos_ids == (ts._end_id, ts.tokenizer.eos_token_id)
    np.testing.assert_array_equal(t["tokens"], j["tokens"])
    assert t["step_hidden"].shape == j["step_hidden"].shape == (NEW_TOKENS - 1, 1, 1, 64)
    np.testing.assert_allclose(t["step_hidden"], j["step_hidden"], atol=1e-5, rtol=0)
    assert tout[0] == jout[0] and len(tout[0]) == 1            # the answers
    assert tout[2] == jout[2]                                  # predictions_text


def test_generate_pads_a_prompt_with_a_slot(pair, monkeypatch):
    # The reference cuts the slot rows to the bucket and never pads them, so
    # its splice fails on this prompt (ROADMAP C10). The port pads them:
    # held to the reference's own pieces on the same prompt unpadded.
    import dataclasses

    from spider_tpu.models.decode import generate as j_decode

    js, ts = pair
    rec = _record_generate(monkeypatch, js, ts)
    samples = _samples(True, pad=True)
    ts.generate(samples, [], empty_predictions(), empty_predictions_text(),
                max_new_tokens=NEW_TOKENS)
    t = rec["torch"]
    Lp = int(t["prompt_len"][0])
    width = t["prompt_ids"].shape[1]
    jb = js.prepare_batch(dict(samples, Answer=[""]))
    assert width % 32 == 0 and Lp < width and jb.input_ids.shape[1] < width   # padded
    out_ids = js._ids("[OUTPUT]")
    ids = np.concatenate([jb.input_ids[:, :-(len(out_ids) + 1)], np.asarray([out_ids])], 1)
    assert ids.shape[1] == Lp
    np.testing.assert_array_equal(t["prompt_ids"][:, :Lp], ids)
    jb = dataclasses.replace(jb, input_ids=ids,
                             slot_mask={m: v[:, :Lp] for m, v in jb.slot_mask.items()},
                             slot_index={m: v[:, :Lp] for m, v in jb.slot_index.items()})
    emb = jS.Spider._splice_embeds(js, js.llm_params, js.llama_proj_params, jb,
                                   js.encode_modalities(jb))
    np.testing.assert_allclose(t["embeds"][:, :Lp], np.asarray(emb), atol=1e-5, rtol=0)
    want = j_decode(js.llm, js.llm_params, emb, jnp.asarray([Lp], jnp.int32), t["cfg"])
    np.testing.assert_array_equal(t["tokens"], np.asarray(want["tokens"]))
    np.testing.assert_allclose(t["step_hidden"], np.asarray(want["step_hidden"]), atol=1e-5,
                               rtol=0)


def test_generate_is_single_sample(pair):
    js, ts = pair
    samples = _samples(False, B=2)
    for spider, preds in ((ts, (empty_predictions(), empty_predictions_text())),
                          (js, (j_empty(), j_empty_text()))):
        with pytest.raises(ValueError, match="single-sample"):
            spider.generate(samples, [], *preds, max_new_tokens=4)


class RecordingPipe:
    """A decoder: its text conditioning is a fixed table looked up by
    caption length (the same numbers for both packages); a generation call
    records the prompt embeddings it was given and returns a fixed array."""

    def __init__(self, shape, seed):
        self.table = np.random.default_rng(seed).standard_normal((32,) + shape).astype(
            np.float32)
        self.calls = []

    def __call__(self, prompt=None, return_prompts_only=False, prompt_embeds=None, **kw):
        if return_prompts_only:
            return np.stack([self.table[len(p) % 32] for p in prompt])
        self.calls.append(dict(prompt_embeds=np.asarray(prompt_embeds), **kw))
        return np.arange(6, dtype=np.float32).reshape(1, 2, 3) + len(self.calls)


# modality -> conditioning shape of the tiny Spider's aligner outputs
PIPE_SHAPES = {"IMAGE": (77, 32), "AUDIO": (16,), "VIDEO": (77, 32)}


def _planted(ts, modality, seed, occurrences=1, n=24, hidden=64):
    """A token row with the modality's [X0..Xn] run planted at known places,
    and random step_hidden [n-1, 1, 1, hidden]."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(40, 120, size=(1, n)).astype(np.int64)
    sig = ts._signal_ids[modality]
    for k in range(occurrences):
        start = 3 + k * (len(sig) + 2)
        tokens[0, start:start + len(sig)] = sig
    step_hidden = rng.standard_normal((n - 1, 1, 1, hidden)).astype(np.float32)
    return tokens, step_hidden


def _both_decode(pair, monkeypatch, modality, tokens, step_hidden, occurrence=0, pipes=True,
                 samples=None):
    js, ts = pair
    out = {}
    for name, spider in (("jax", js), ("torch", ts)):
        pipe = RecordingPipe(PIPE_SHAPES.get(modality, (4,)), seed=5) if pipes else None
        monkeypatch.setattr(spider, "diffusion_pipes", {modality: pipe} if pipes else {})
        sh = step_hidden if name == "jax" else torch.from_numpy(step_hidden)
        res = spider._decode_modality_infer(modality, occurrence, "a red bird", tokens, sh,
                                            samples or {}, 7.5, 3)
        out[name] = (res, pipe)
    return out


@pytest.mark.parametrize("modality", ["IMAGE", "AUDIO", "VIDEO"])
@pytest.mark.parametrize("occurrence", [0, 1])
def test_decode_modality_fuses_like_jax(pair, monkeypatch, modality, occurrence):
    tokens, step_hidden = _planted(pair[1], modality, seed=1 + occurrence, occurrences=2)
    out = _both_decode(pair, monkeypatch, modality, tokens, step_hidden, occurrence)
    (jres, jpipe), (tres, tpipe) = out["jax"], out["torch"]
    assert len(jpipe.calls) == len(tpipe.calls) == 1
    jc, tc = jpipe.calls[0], tpipe.calls[0]
    want_shape = (1,) + PIPE_SHAPES[modality]      # AUDIO: proj[:, 0] against a 2-d cond
    assert tc["prompt_embeds"].shape == jc["prompt_embeds"].shape == want_shape
    assert tc["prompt_embeds"].dtype == np.float32
    np.testing.assert_allclose(tc["prompt_embeds"], jc["prompt_embeds"], atol=1e-5, rtol=0)
    cond = tpipe.table[len("a red bird") % 32][None]
    assert np.abs(tc["prompt_embeds"] - cond).max() > 1e-3    # the projection is in it
    assert tc["guidance_scale"] == jc["guidance_scale"] == 7.5
    assert tc["num_inference_steps"] == jc["num_inference_steps"] == 3
    np.testing.assert_array_equal(np.asarray(tres), np.asarray(jres))   # result[0] or whole


@pytest.mark.parametrize("modality", ["IMAGE", "AUDIO"])
def test_decode_modality_without_a_signal_run_uses_the_conditioning_alone(
        pair, monkeypatch, modality):
    tokens = np.random.default_rng(3).integers(40, 120, size=(1, 16))
    step_hidden = np.zeros((15, 1, 1, 64), np.float32)
    out = _both_decode(pair, monkeypatch, modality, tokens, step_hidden)
    (_, jpipe), (_, tpipe) = out["jax"], out["torch"]
    cond = tpipe.table[len("a red bird") % 32][None]
    np.testing.assert_array_equal(tpipe.calls[0]["prompt_embeds"], cond)
    np.testing.assert_array_equal(jpipe.calls[0]["prompt_embeds"], cond)


def test_decode_modality_box_mask_and_missing_pipe(pair, monkeypatch):
    js, ts = pair
    tokens, step_hidden = _planted(ts, "IMAGE", seed=4)
    seen = []

    def box_decoder(image, cap):
        seen.append((image.shape, cap))
        return {"bboxes": [[1.0, 2.0, 3.0, 4.0]], "label_names": [cap], "scores": [0.75]}

    samples = {"Image_ori_array": [np.zeros((8, 8, 3), np.uint8)]}
    for spider in (js, ts):
        monkeypatch.setattr(spider, "box_decoder", box_decoder)
    got = {}
    for name, spider in (("jax", js), ("torch", ts)):
        got[name] = spider._decode_modality_infer("BOX", 0, "a dog", tokens, step_hidden,
                                                  samples, 7.5, 3)
        # no image given: no box
        assert spider._decode_modality_infer("BOX", 0, "a dog", tokens, step_hidden, {},
                                             7.5, 3) is None
        # MASK decodes to nothing without SAM, a missing pipe to nothing
        assert spider._decode_modality_infer("MASK", 0, "a dog", tokens, step_hidden,
                                             samples, 7.5, 3) is None
        monkeypatch.setattr(spider, "diffusion_pipes", {})
        assert spider._decode_modality_infer("IMAGE", 0, "a dog", tokens, step_hidden,
                                             samples, 7.5, 3) is None
    assert got["torch"] == got["jax"] == dict(
        outputs_bboxes=[[[1.0, 2.0, 3.0, 4.0]]], outputs_label_names=[["a dog"]],
        outputs_scores=[[0.75]])
    assert seen == [((8, 8, 3), "a dog")] * 2


def test_generate_dispatches_planted_spans(pair, monkeypatch):
    # A random model never emits tags: hand generate a decode whose tokens
    # spell an answer with an IMAGE span and its signal run, as a trained
    # checkpoint would, and hold the dispatch and the BOX-free predictions.
    ts = pair[1]
    answer = "Here.<IMAGE>a cat" + "".join(f"[IMAGE{i}]" for i in range(4)) + "</IMAGE>[END]"
    ids = ts._ids(answer)
    n = len(ids) + 2
    h = np.random.default_rng(9).standard_normal((n - 1, 1, 1, 64)).astype(np.float32)
    tokens = np.full((1, n), ts.tokenizer.pad_token_id, np.int64)
    tokens[0, : len(ids)] = ids

    def fake_decode(model, embeds, prompt_len, cfg, generator=None):
        return dict(tokens=torch.from_numpy(tokens), step_hidden=torch.from_numpy(h))

    monkeypatch.setattr(tS, "generate", fake_decode)
    pipe = RecordingPipe(PIPE_SHAPES["IMAGE"], seed=5)
    monkeypatch.setattr(ts, "diffusion_pipes", {"IMAGE": pipe})
    answers, preds, texts = ts.generate(_samples(False), [], empty_predictions(),
                                        empty_predictions_text(), max_new_tokens=n)
    assert answers == ["Here.<IMAGE>a cat[IMAGE0][IMAGE1][IMAGE2][IMAGE3]</IMAGE>"]
    assert texts["IMAGE"] == ["a cat"]      # the training grammar's caption wins
    assert len(preds["IMAGE"]) == 1 and len(pipe.calls) == 1
    np.testing.assert_array_equal(preds["IMAGE"][0], np.arange(6).reshape(2, 3) + 1)
    ts._decode_modality_infer("IMAGE", 0, "a cat", tokens, torch.from_numpy(h), {}, 7.5, 40)
    np.testing.assert_allclose(pipe.calls[0]["prompt_embeds"], pipe.calls[1]["prompt_embeds"])


# ---------------------------------------------------------------------------
# SpiderInference and load_demo_checkpoint
# ---------------------------------------------------------------------------

STORY = ("Once.<IMAGESTORY><GENERALPROMPT>a fox</GENERALPROMPT>"
         "<PROMPTARRAY>[\"runs\", \"sleeps\"]</PROMPTARRAY>"
         "<STYLENAME>Comic book</STYLENAME></IMAGESTORY>")


class StubModel:
    """Answers every request with a fixed story text."""

    def generate(self, samples, answers, predictions, predictions_text, **kw):
        answers.append(STORY)
        return answers, predictions, predictions_text

    def update_params(self, tree):
        raise AssertionError("no checkpoint is loaded here")


def test_spider_inference_story_path_matches_jax():
    from spider_tpu.common.config import Config as JConfig
    from spider_tpu.serving.inference_api import SpiderInference as JInference
    from spider_tpu_torch.common.config import Config
    from spider_tpu_torch.serving.inference_api import SpiderInference

    calls = {"jax": [], "torch": []}

    def story_fn(name):
        def fn(general_prompt, prompt_array, style_name):
            calls[name].append((general_prompt, list(prompt_array), style_name))
            return ["frame"] * len(prompt_array)
        return fn

    blob = {"model": {"type": "spider"}, "run": {}}
    jres = JInference(JConfig.fromdict(blob), model=StubModel(), story_fn=story_fn("jax"))(
        {"Question": ["tell a story"]})
    tres = SpiderInference(Config.fromdict(blob), model=StubModel(),
                           story_fn=story_fn("torch"))({"Question": ["tell a story"]})
    assert tres[0] == jres[0] == [STORY]
    assert tres[2] == jres[2]
    assert tres[2]["IMAGESTORY_prompts"] == [["runs", "sleeps"]]
    assert calls["torch"] == calls["jax"] == [("a fox", ["runs", "sleeps"], "Comic book")]
    assert tres[1]["IMAGESTORY"] == jres[1]["IMAGESTORY"] == [["frame", "frame"]]
    # without a story_fn the span is still reported, and nothing is rendered
    tres = SpiderInference(Config.fromdict(blob), model=StubModel())({"Question": ["x"]})
    assert tres[2]["IMAGESTORY"] and tres[1]["IMAGESTORY"] == []


def _tiny_runner_checkpoint(tmp_path, patterns=None):
    """A tiny Spider trained two steps by RunnerBase, saved by
    save_checkpoint: (model, checkpoint path)."""
    from spider_tpu_torch.common.config import Config
    from spider_tpu_torch.runners.runner import RunnerBase

    model = tF.build_tiny_spider(device="cpu", with_pipes=False)
    run = dict(init_lr=1e-2, lr_sched="linear_warmup_step_lr", max_epoch=1, iters_per_epoch=1,
               output_dir=str(tmp_path), weight_decay=0.0, warmup_steps=0)
    if patterns:
        run["trainable_patterns"] = patterns
    cfg = Config.fromdict(dict(model=dict(type="spider", preset="tiny"), run=run))
    runner = RunnerBase(cfg=cfg, task=None, model=model, datasets={}, job_id="t")
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in runner.optimizer.params.values():
            p.add_(0.01 * torch.randn(p.shape, generator=g))
    return model, runner.save_checkpoint(0)


@pytest.mark.parametrize("patterns", [None, ("lora_", "moe_aligner", "aligners")],
                         ids=["all_trainable", "trainable_patterns"])
def test_load_demo_checkpoint_restores_bit_equal(tmp_path, patterns):
    from spider_tpu_torch.serving.inference_api import load_demo_checkpoint

    trained, path = _tiny_runner_checkpoint(tmp_path, patterns)
    saved = torch.load(path, weights_only=True)["params"]
    fresh = tF.build_tiny_spider(device="cpu", with_pipes=False)
    demo = tmp_path / "demo_config.json"
    demo.write_text(json.dumps({"type": "pt", "checkpoints": [str(tmp_path / "absent.pt"),
                                                               path]}))
    assert load_demo_checkpoint(fresh, str(demo)) is True
    named = dict(fresh.named_parameters())
    trained_named = dict(trained.named_parameters())
    assert saved and set(saved) <= set(named)
    for n, t in saved.items():
        assert torch.equal(named[n], t) and torch.equal(named[n], trained_named[n]), n
    if patterns:                         # what the checkpoint does not hold stays as built
        untouched = [n for n in named if n not in saved and not n.startswith("encoder.")]
        assert untouched
        ref = dict(tF.build_tiny_spider(device="cpu", with_pipes=False).named_parameters())
        assert all(torch.equal(named[n], ref[n]) for n in untouched)


def test_load_demo_checkpoint_missing_orbax_and_unknown(tmp_path, caplog):
    from spider_tpu_torch.serving.inference_api import load_demo_checkpoint

    model = tF.build_tiny_spider(device="cpu", with_pipes=False)
    demo = tmp_path / "demo.json"
    demo.write_text(json.dumps({"checkpoints": [str(tmp_path / "nowhere")]}))
    assert load_demo_checkpoint(model, str(demo)) is False
    assert "no checkpoint found" in caplog.text
    orbax = tmp_path / "orbax_ckpt"
    os.makedirs(orbax / "params")
    demo.write_text(json.dumps({"checkpoints": [str(orbax)]}))
    with pytest.raises(NotImplementedError, match="orbax"):
        load_demo_checkpoint(model, str(demo))
    bad = tmp_path / "bad.pt"
    torch.save({"params": {"not.a.parameter": torch.zeros(2)}}, bad)
    demo.write_text(json.dumps({"checkpoints": [str(bad)]}))
    with pytest.raises(KeyError, match="not.a.parameter"):
        load_demo_checkpoint(model, str(demo))


def test_spider_inference_builds_from_config_and_restores(tmp_path):
    from spider_tpu_torch.common.config import Config
    from spider_tpu_torch.serving.inference_api import SpiderInference

    trained, path = _tiny_runner_checkpoint(tmp_path)
    demo = tmp_path / "demo_config.json"
    demo.write_text(json.dumps({"checkpoints": [path]}))
    pipe = RecordingPipe((77, 32), seed=5)
    cfg = Config.fromdict(dict(model=dict(type="spider", preset="tiny", with_pipes=False),
                               run=dict(demo_config=str(demo))))
    inf = SpiderInference(cfg, device="cpu", diffusion_pipes={"IMAGE": pipe})
    assert inf.model.diffusion_pipes == {"IMAGE": pipe}
    want = dict(trained.named_parameters())
    for n, p in inf.model.named_parameters():
        assert torch.equal(p, want[n]), n
    samples = _samples(False)
    a = inf(samples, max_new_tokens=6)
    b = trained.generate(samples, [], empty_predictions(), empty_predictions_text(),
                         max_new_tokens=6)
    assert a[0] == b[0]
