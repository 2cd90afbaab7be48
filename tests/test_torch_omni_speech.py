"""The port's Qwen2.5-Omni speech pipeline and its three entry twins against
the JAX package: ``OmniSpeechPipeline.speak`` and ``chat_with_speech``, the
speaker dictionary, the factory kind ``omni_speech`` and the
``qwen2_5omni_{infer,web,spider_web}`` twins on ``--device cpu``.

Weights: the modules of the JAX package's ``build_tiny_omni_speech`` with
shape-true random parameters (``random_params_like``; the thinker's as in
test_torch_omni_thinker), carried to the port through ``load_jax_params``
part by part. fp32 on the CPU. The
reference draws the talker's ids with ``jax.random`` and the port with a
``torch.Generator``: the waveform is compared under ``top_k`` 1 (forced
draws) with the DiT's initial noise drawn as the reference draws it and
injected, within the DiT's bound, 1e-4 + 1e-4 |wave|; codec ids and greedy
text are equal exactly.
"""

import dataclasses
import functools
import importlib.util
import json
import os
import sys
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spider_tpu.models import omni_speech as js
from spider_tpu.models import omni_talker as jt
from spider_tpu_torch.models import factory
from spider_tpu_torch.models import llama as L
from spider_tpu_torch.models import omni_speech as ts
from spider_tpu_torch.models import omni_talker as tt
from spider_tpu_torch.models import omni_token2wav as tw
from spider_tpu_torch.models import qwen_omni as tq
from spider_tpu_torch.models.convert import load_jax_params
from spider_tpu_torch.models.tokenizer import TinyTokenizer
from test_torch_grounding import _manifest
from test_torch_omni_thinker import Recording, jax_tiny_thinker

ATOL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def carried(jpipe) -> ts.OmniSpeechPipeline:
    """The port's pipeline on the JAX pipeline's weights."""
    jth = jpipe.thinker
    audio = load_jax_params(tq.OmniAudioEncoder(dataclasses.replace(
        tq.omni_audio_tiny(), output_dim=jth.audio_enc.config.output_dim)), jth.audio_params)
    vision = load_jax_params(tq.OmniVisionEncoder(dataclasses.replace(
        tq.omni_vision_tiny(), out_hidden_size=jth.vision_enc.config.out_hidden_size)),
        jth.vision_params)
    llm = load_jax_params(L.LlamaForCausalLM(dataclasses.replace(
        tq.thinker_tiny_llm(), vocab_size=jth.llm.config.vocab_size)), jth.llm_params)
    thinker = tq.QwenOmniThinker(llm.eval(), TinyTokenizer(), audio.eval(), vision.eval(),
                                 max_new_tokens=jth.max_new_tokens)
    talker = load_jax_params(tt.OmniTalker(dataclasses.replace(
        tt.talker_tiny(), embedding_size=jpipe.talker.config.embedding_size)),
        jpipe.generator.params).eval()
    t2w = jpipe.token2wav
    dcfg = dataclasses.replace(tw.dit_tiny(), num_embeds=t2w.dit.config.num_embeds)
    token2wav = tw.OmniToken2Wav(load_jax_params(tw.DiTModel(dcfg), t2w.dit_params).eval(),
                                 load_jax_params(tw.BigVGAN(tw.bigvgan_tiny()),
                                                 t2w.vocoder_params).eval())
    return ts.OmniSpeechPipeline(thinker, talker, token2wav)


def _jax_token2wav(num_embeds=None):
    """The JAX tiny token2wav; with num_embeds, its DiT's codebook widened
    so that every id of the tiny talker has a row (ROADMAP C15)."""
    from spider_tpu.models import omni_token2wav as jw
    from spider_tpu.models.factory import random_params_like

    stock = jw.build_tiny_token2wav()
    if num_embeds is None:
        return stock
    cfg = dataclasses.replace(jw.dit_tiny(), num_embeds=num_embeds)
    dit = jw.DiTModel(cfg)
    params = random_params_like(dit, jax.random.PRNGKey(5), jnp.zeros((1, 8, cfg.mel_dim)),
                                jnp.zeros((1, 8, cfg.enc_emb_dim)), jnp.zeros((1, 6, cfg.mel_dim)),
                                jnp.zeros((1, 4), jnp.int32), jnp.zeros((1,)))
    return jw.OmniToken2Wav(dit, jax.tree_util.tree_map(jnp.asarray, params), stock.vocoder,
                            stock.vocoder_params)


@functools.lru_cache(maxsize=None)
def _pair():
    """The JAX pipeline of ``build_tiny_omni_speech``'s modules (the thinker
    of ``jax_tiny_thinker``, a random talker, the token2wav above) with the
    talker's draws forced (top_k 1), and the port's on its weights."""
    from spider_tpu.models.factory import random_params_like

    thinker = jax_tiny_thinker()
    tcfg = dataclasses.replace(jt.talker_tiny(), embedding_size=thinker.llm.config.hidden_size)
    talker = jt.OmniTalker(tcfg)
    tparams = jax.tree_util.tree_map(jnp.asarray, random_params_like(
        talker, jax.random.PRNGKey(4), jnp.zeros((1, 4, tcfg.embedding_size)),
        method="init_all"))
    jpipe = js.OmniSpeechPipeline(thinker, talker, tparams,
                                  _jax_token2wav(num_embeds=tcfg.vocab_size),
                                  sampling=jt.TalkerSampling(top_k=1))
    pipe = carried(jpipe)
    pipe.generator.s = tt.TalkerSampling(top_k=1)
    return jpipe, pipe


def test_speak_matches_jax_under_forced_draws():
    # the reference's default voice; a named speaker's conditioning runs the
    # same DiT and ECAPA code, held to the reference in test_torch_omni_token2wav
    jpipe, pipe = _pair()
    text, streams = pipe.thinker.chat("Say <IMAGE-Placeholder> aloud", images=[_x((16, 24, 3), 1)],
                                      return_talker_streams=True)
    dcfg = pipe.token2wav.dit.config
    key = jax.random.PRNGKey(11)
    want = jpipe.speak(streams, max_speech_tokens=10, num_flow_steps=3, rng=key)
    codes = pipe.talk(streams, pipe.default_speaker(), 10)
    assert 1 <= len(codes) <= 11
    _, wav_key = jax.random.split(key)
    noise = np.array(jax.random.normal(wav_key, (1, len(codes) * dcfg.repeats, dcfg.mel_dim),
                                       jnp.float32))
    got = pipe.speak(streams, max_speech_tokens=10, num_flow_steps=3,
                     noise=torch.from_numpy(noise))
    assert got.dtype == np.float32 and got.shape == want.shape == (len(codes) * 2 * 4,)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


def test_ids_without_a_codebook_row_are_not_drawn():
    # ROADMAP C15: the reference's codec embedding (flax Embed, jnp.take)
    # gives NaN rows past its table; with the stock tiny DiT (17 rows) the
    # talker alone draws such ids here, the pipeline only ids it can voice
    import flax.linen as fnn

    emb = fnn.Embed(17, 4)
    table = emb.init(jax.random.PRNGKey(0), jnp.zeros((1,), jnp.int32))
    assert np.isnan(np.asarray(emb.apply(table, jnp.asarray([16, 17])))[1]).all()
    jpipe, pipe = _pair()
    stock = tw.OmniToken2Wav(load_jax_params(tw.DiTModel(tw.dit_tiny()),
                                             _jax_token2wav().dit_params).eval(),
                             pipe.token2wav.vocoder)
    pipe2 = ts.OmniSpeechPipeline(pipe.thinker, pipe.talker, stock,
                                  sampling=tt.TalkerSampling(top_k=1))
    _, streams = pipe2.thinker.chat("Say <IMAGE-Placeholder> aloud", images=[_x((16, 24, 3), 1)],
                                    return_talker_streams=True)
    rows = stock.dit.config.num_embeds + 1
    cfg = pipe2.talker.config
    emb = pipe2._embed_text_id
    pos = np.concatenate([streams["positions"], np.broadcast_to(
        np.asarray([1, 2], np.int32) + streams["positions"].max(), (3, 1, 2))], -1)
    alone = pipe2.generator.generate(streams["prompt_stream"], emb(cfg.text_bos),
                                     streams["reply_stream"], emb(cfg.text_eos),
                                     emb(cfg.text_pad), prefill_positions=pos, max_new_tokens=10)
    assert (alone >= rows).any()
    codes = pipe2.talk(streams, pipe2.default_speaker(), 10)
    assert len(codes) and (codes < rows).all()
    wav = pipe2.speak(streams, max_speech_tokens=10, num_flow_steps=2)
    assert wav.size == len(codes) * 8 and np.isfinite(wav).all()
    # token2wav refuses an id past the table (the reference voices it as NaN)
    spk = pipe2.default_speaker()
    with pytest.raises(ValueError, match=rf"codec ids \[{rows}\] have no row"):
        pipe2.token2wav(np.asarray([[0, rows - 1, rows]]), spk.cond, spk.ref_mel, num_steps=2)


def test_immediate_eos_unknown_speaker_and_speaker_file(tmp_path):
    _, pipe = _pair()
    _, streams = pipe.thinker.chat("x", return_talker_streams=True)
    real = pipe.generator.generate
    pipe.generator.generate = lambda *a, **k: np.zeros((0,), np.int32)    # codec EOS first
    try:
        wav = pipe.speak(streams)
    finally:
        pipe.generator.generate = real
    assert wav.dtype == np.float32 and wav.shape == (0,)
    with pytest.raises(KeyError, match="unknown speaker 'nope'"):
        pipe.chat_with_speech("hello", speaker="nope", max_speech_tokens=2)
    # spk_dict.pt as the release ships it: {name: {bos_token, cond, ref_mel}}
    path = str(tmp_path / "spk_dict.pt")
    torch.save({"Chelsie": {"bos_token": 5, "cond": torch.ones(6),
                            "ref_mel": torch.zeros(8, 8)}}, path)
    spk = ts.read_speakers(path)["Chelsie"]
    assert spk.bos_token == 5 and spk.cond.shape == (1, 6) and spk.ref_mel.shape == (1, 8, 8)
    assert ts.default_spk_path(str(tmp_path)) == path and ts.default_spk_path(None) is None
    pipe.speakers = {"Chelsie": spk}
    try:
        text, wav = pipe.chat_with_speech("hello", speaker="Chelsie", max_speech_tokens=3,
                                          num_flow_steps=2)
    finally:
        pipe.speakers = {}
    assert isinstance(text, str) and wav.ndim == 1 and wav.size % 8 == 0
    assert np.all(np.abs(wav) <= 1.0)


def _speech_checkpoint(tmp_path, monkeypatch):
    """A Qwen2.5-Omni checkpoint directory of the tiny pipeline's weights (the
    thinker, talker and token2wav keys of one file, spk_dict.pt beside it),
    the full presets swapped for the tiny ones."""
    from spider_tpu_torch.models import checkpoint_io as io
    from spider_tpu_torch.models import convert as TC

    _, pipe = _pair()
    th = pipe.thinker
    lcfg = dataclasses.replace(th.llm.config, dtype=torch.float32)
    monkeypatch.setattr(tq, "omni_audio_full", lambda: th.audio_enc.config)
    monkeypatch.setattr(tq, "omni_vision_full", lambda: th.vision_enc.config)
    monkeypatch.setattr(tq, "thinker_llm_full", lambda: lcfg)
    monkeypatch.setattr(tt, "talker_full", lambda: pipe.talker.config)
    monkeypatch.setattr(tw, "dit_full", lambda: pipe.token2wav.dit.config)
    monkeypatch.setattr(tw, "bigvgan_full", tw.bigvgan_tiny)
    sd = {}
    keys = lambda name: set(_manifest(name))          # where the optional biases are
    for pre, module, rules in (
            ("thinker.audio_tower.", th.audio_enc,
             TC.omni_audio_rules(keys("omni_audio_tower"), th.audio_enc.config, prefix="")),
            ("thinker.visual.", th.vision_enc,
             TC.omni_vision_rules(keys("omni_vision_tower"), th.vision_enc.config, prefix="")),
            ("thinker.", th.llm, TC.llama_rules({"lm_head.weight"}, th.llm.config)),
            ("talker.", pipe.talker, TC.omni_talker_rules(keys("omni_talker"),
                                                          pipe.talker.config)),
            ("token2wav.code2wav_dit_model.", pipe.token2wav.dit,
             TC.omni_dit_rules(keys("omni_dit"), pipe.token2wav.dit.config)),
            ("token2wav.code2wav_bigvgan_model.", pipe.token2wav.vocoder,
             TC.omni_bigvgan_rules(keys("omni_bigvgan"), pipe.token2wav.vocoder.config))):
        part = TC.export_state_dict(rules, module.state_dict())
        sd.update({pre + k: v.contiguous() for k, v in part.items()})
    io.save_file(sd, str(tmp_path / "model.safetensors"))
    torch.save({"Ethan": {"bos_token": 7, "cond": torch.ones(6), "ref_mel": torch.zeros(8, 8)}},
               str(tmp_path / "spk_dict.pt"))
    return pipe


def _assert_same_weights(got, pipe):
    th = pipe.thinker
    for a, b in ((got.thinker.llm, th.llm), (got.thinker.audio_enc, th.audio_enc),
                 (got.thinker.vision_enc, th.vision_enc), (got.talker, pipe.talker),
                 (got.token2wav.dit, pipe.token2wav.dit),
                 (got.token2wav.vocoder, pipe.token2wav.vocoder)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sorted(sa) == sorted(sb)
        assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_omni_speech_from_a_checkpoint_directory(tmp_path, monkeypatch):
    # from_pretrained('omni_speech', path=...) at test widths
    pipe = _speech_checkpoint(tmp_path, monkeypatch)
    got = factory.from_pretrained("omni_speech", path=str(tmp_path), device="cpu",
                                  dtype=torch.float32)
    assert isinstance(got, ts.OmniSpeechPipeline) and list(got.speakers) == ["Ethan"]
    _assert_same_weights(got, pipe)


def test_omni_speech_builds_the_widths_its_config_states(tmp_path, monkeypatch):
    # The presets of the talker and the thinker's LLM are other than the
    # checkpoint's; its config.json states the checkpoint's widths under the
    # names of transformers' Qwen2.5-Omni configs, and the builders follow them.
    from spider_tpu_torch.models import convert as TC

    pipe = _speech_checkpoint(tmp_path, monkeypatch)
    tc, lc = pipe.talker.config, pipe.thinker.llm.config
    monkeypatch.setattr(tt, "talker_full", lambda: dataclasses.replace(
        tc, hidden_size=2 * tc.hidden_size, intermediate_size=3 * tc.intermediate_size,
        num_hidden_layers=tc.num_hidden_layers + 1, num_attention_heads=2 * tc.num_attention_heads,
        num_key_value_heads=1, head_dim=2 * tc.head_dim, embedding_size=tc.embedding_size + 8,
        vocab_size=tc.vocab_size + 4, mrope_section=None, codec_bos=0, codec_eos=1))
    wrong_llm = dataclasses.replace(lc, dtype=torch.float32, hidden_size=2 * lc.hidden_size,
                                    num_hidden_layers=lc.num_hidden_layers + 1)
    monkeypatch.setattr(tq, "thinker_llm_full", lambda: wrong_llm)
    talker = dict(vocab_size=tc.vocab_size, embedding_size=tc.embedding_size,
                  hidden_size=tc.hidden_size, intermediate_size=tc.intermediate_size,
                  num_hidden_layers=tc.num_hidden_layers,
                  num_attention_heads=tc.num_attention_heads,
                  num_key_value_heads=tc.num_key_value_heads, head_dim=tc.head_dim,
                  rope_scaling={"mrope_section": list(tc.mrope_section), "type": "default"},
                  tts_codec_start_token_id=tc.codec_bos, tts_codec_end_token_id=tc.codec_eos,
                  hidden_act="silu")
    text = dict(hidden_size=lc.hidden_size, num_hidden_layers=lc.num_hidden_layers,
                rope_scaling={"mrope_section": list(lc.mrope_section)})
    with open(tmp_path / "config.json", "w") as f:
        json.dump({"thinker_config": {"text_config": text}, "talker_config": talker}, f)
    stated = TC.read_omni_config(str(tmp_path))
    assert stated["llm"] == dict(hidden_size=lc.hidden_size,
                                 num_hidden_layers=lc.num_hidden_layers,
                                 mrope_section=tuple(lc.mrope_section))
    assert stated["talker"]["codec_eos"] == tc.codec_eos and "hidden_act" not in stated["talker"]
    got = factory.from_pretrained("omni_speech", path=str(tmp_path), device="cpu",
                                  dtype=torch.float32)
    assert got.talker.config == dataclasses.replace(tc, dtype=torch.float32,
                                                    param_dtype=torch.float32)
    assert got.thinker.llm.config == lc
    _assert_same_weights(got, pipe)


# ---- the entry twins ----------------------------------------------------------------

def _root_script(name):
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  os.path.join(ROOT, name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_infer_twin_with_the_omni_thinker_answers_as_the_jax_thinker(monkeypatch, capsys):
    from spider_tpu.common.config import Config as JConfig
    from spider_tpu.models import qwen_omni as jq
    from spider_tpu.serving.spider_free import SpiderFree as JSpiderFree
    from spider_tpu_torch import qwen2_5omni_infer as twin

    jpipe, pipe = _pair()
    jtok, ttok = Recording(), Recording()
    monkeypatch.setattr(jpipe.thinker, "tokenizer", jtok)
    monkeypatch.setattr(pipe.thinker, "tokenizer", ttok)
    monkeypatch.setenv("SPIDER_TPU_OMNI", "1")
    monkeypatch.delenv("SPIDER_TPU_OMNI_CKPT", raising=False)
    monkeypatch.delenv("QWEN_OMNI_PATH", raising=False)
    monkeypatch.setattr(tq, "build_tiny_omni_thinker", lambda **kw: pipe.thinker)
    monkeypatch.setattr(jq, "build_tiny_omni_thinker", lambda *a, **kw: jpipe.thinker)
    answer = twin.main(["A question about horses.", "--device", "cpu"])
    assert capsys.readouterr().out.startswith(f"answer: {answer}\n")
    root = _root_script("qwen2.5omni_infer.py")
    cfg = JConfig.fromfile(os.path.join(ROOT, "train_configs", "spider_decoder_cfg.py"))
    _, answers, _, _ = JSpiderFree(cfg, root.build_chat_fn(), decoders={}).chat(
        "A question about horses.")
    assert answer == answers[0] and ttok.ids == jtok.ids and len(ttok.ids) > 1


def test_infer_twin_text_backbone_refuses_media(monkeypatch):
    from spider_tpu_torch import qwen2_5omni_infer as twin

    for name in ("SPIDER_TPU_OMNI", "QWEN_OMNI_PATH", "SPIDER_TPU_LLM_CKPT"):
        monkeypatch.delenv(name, raising=False)
    chat_fn = twin.build_chat_fn(device="cpu")
    assert isinstance(chat_fn("Hi"), str)
    with pytest.raises(ValueError, match="text-only Llama backbone"):
        chat_fn("Hi", images=[_x((8, 8, 3), 0)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        twin.main(["Hi"])                      # cuda is the default: it never falls back


def _stub_transformers(monkeypatch, seen):
    """A transformers module whose Omni model and processor record the device
    the model was moved to and the devices of the tensors generate is given."""
    import types

    class Processor:
        def apply_chat_template(self, conversation, tokenize, add_generation_prompt):
            return conversation[0]["content"][-1]["text"]

        def __call__(self, text, audio, images, videos, return_tensors, padding):
            return {"input_ids": torch.tensor([[1, 2, 3]]),
                    "attention_mask": torch.ones(1, 3, dtype=torch.long), "note": text}

        def batch_decode(self, gen, skip_special_tokens):
            return [f"{gen.shape[1]} new"]

    class Model:
        def to(self, device):
            seen["model"] = torch.device(device)
            return self

        def generate(self, **inputs):
            seen["inputs"] = {k: v.device for k, v in inputs.items() if torch.is_tensor(v)}
            ids = inputs["input_ids"]
            return torch.cat([ids, torch.tensor([[7, 8]], device=ids.device)], 1)

    mod = types.ModuleType("transformers")
    mod.AutoProcessor = types.SimpleNamespace(from_pretrained=lambda path: Processor())
    mod.Qwen2_5OmniForConditionalGeneration = types.SimpleNamespace(
        from_pretrained=lambda path: Model())
    monkeypatch.setitem(sys.modules, "transformers", mod)


def test_transformers_adapter_runs_on_the_device_it_is_given(monkeypatch, tmp_path):
    from spider_tpu_torch import qwen2_5omni_infer as twin
    from spider_tpu_torch import qwen2_5omni_web as web

    seen = {}
    _stub_transformers(monkeypatch, seen)
    meta = torch.device("meta")             # a device other than the CPU the tensors start on
    monkeypatch.setenv("QWEN_OMNI_PATH", str(tmp_path))
    assert twin.build_chat_fn(device=meta)("Hi") == "2 new"
    assert seen == {"model": meta, "inputs": {"input_ids": meta, "attention_mask": meta}}
    # the web twin hands its --device to the same adapter
    got = []
    monkeypatch.setattr(twin, "build_omni_chat_fn",
                        lambda path, device: got.append((path, device)) or (lambda *a, **k: ""))
    monkeypatch.setenv("OMNI_CKPT", str(tmp_path))
    server = web.main(["--port", "0", "--device", "cpu"], background=True)
    server.shutdown()
    server.server_close()
    assert got == [(str(tmp_path), torch.device("cpu"))]


def _post(port, body, stream):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/chat",
                                 data=json.dumps(dict(body, stream=stream)).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        raw = r.read().decode()
    if not stream:
        return json.loads(raw)
    return [json.loads(line[len("data: "):]) for line in raw.splitlines()
            if line.startswith("data: ")]


def test_web_twin_streams_text_then_the_speech(monkeypatch):
    from spider_tpu_torch import qwen2_5omni_web as twin

    monkeypatch.delenv("OMNI_CKPT", raising=False)
    server = twin.main(["--port", "0", "--device", "cpu"], background=True)
    try:
        events = _post(server.server_address[1], {"text": "Hello"}, stream=True)
    finally:
        server.shutdown()
        server.server_close()
    assert [e["kind"] for e in events] == ["text", "audio", "done"]
    # the same reply and waveform from the port's pipeline, called directly
    pipe = ts.build_tiny_omni_speech(device="cpu")
    text, wav = pipe.chat_with_speech("\nUser: Hello\nOutput:")
    from spider_tpu_torch.serving.spider_free import extract_answer

    assert events[0]["answer"] == extract_answer(text)
    from spider_tpu_torch.serving.http_server import _encode_wav

    assert events[1]["data"] == _encode_wav(wav)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        twin.main(["--port", "0"], background=True)


def test_spider_web_twin_serves_the_selected_backbone(monkeypatch):
    from spider_tpu_torch import qwen2_5omni_spider_web as twin

    for name in ("SPIDER_TPU_OMNI", "QWEN_OMNI_PATH", "SPIDER_TPU_LLM_CKPT"):
        monkeypatch.delenv(name, raising=False)
    server = twin.main(["--port", "0", "--device", "cpu"], background=True)
    try:
        out = _post(server.server_address[1], {"text": "Hello"}, stream=False)
    finally:
        server.shutdown()
        server.server_close()
    assert isinstance(out["answer"], str) and out["events"] == []
