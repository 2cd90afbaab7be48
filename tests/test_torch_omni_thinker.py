"""Parity of the port's Qwen2.5-Omni thinker with the JAX package: the numpy
host helpers, the audio and vision towers, ``QwenOmniThinker.chat`` with the
talker streams it captures, and the thinker rule sets.

Weights: the modules of the JAX package's ``build_tiny_omni_thinker`` with
shape-true random parameters (norm scales 1) and N(0, 0.05) noise added to
every tower leaf and N(0, 0.02) to every decoder leaf, carried to the port
through ``load_jax_params``; inputs are made with
numpy from seeds. fp32 on the CPU. Tower outputs and the captured streams
are held to 1e-4 absolute (the same fp32 arithmetic in another order);
greedy text, m-RoPE positions, host-helper outputs and converted tensors are
equal exactly.
"""

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

from spider_tpu.models import convert as JC
from spider_tpu.models import qwen_omni as jq
from spider_tpu_torch.models import checkpoint_io as io
from spider_tpu_torch.models import convert as TC
from spider_tpu_torch.models import factory
from spider_tpu_torch.models import llama as L
from spider_tpu_torch.models import qwen_omni as tq
from spider_tpu_torch.models.convert import load_jax_params
from spider_tpu_torch.models.tokenizer import TinyTokenizer
from test_torch_grounding import _assert_same_state, _manifest, _np_tree, perturbed

ATOL = 1e-4
PROMPT = ("Listen <AUDIO-Placeholder> then look at <IMAGE-Placeholder> and "
          "<VIDEO-Placeholder>: what happens?")


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


_NORMS = ("scale", "input_layernorm", "post_attention_layernorm", "norm", "norm1", "norm2",
          "ln_q")


def jax_tiny_thinker():
    """The JAX package's tiny thinker (``build_tiny_omni_thinker``'s modules
    and configs) with shape-true random parameters (``random_params_like``,
    which skips compiling the modules' inits), norm scales 1, and N(0, 0.05)
    noise on every tower leaf and N(0, 0.02) on every decoder leaf."""
    import jax
    import jax.numpy as jnp

    from spider_tpu.models.factory import random_params_like
    from spider_tpu.models.llama import LlamaForCausalLM

    def unit_norms(tree):
        return jax.tree_util.tree_map_with_path(
            lambda path, x: np.ones(x.shape, np.float32)
            if getattr(path[-1], "key", None) in _NORMS else x, tree)

    key = jax.random.PRNGKey(0)
    lcfg = dataclasses.replace(jq.thinker_tiny_llm(), vocab_size=512)
    acfg = dataclasses.replace(jq.omni_audio_tiny(), output_dim=lcfg.hidden_size)
    vcfg = dataclasses.replace(jq.omni_vision_tiny(), out_hidden_size=lcfg.hidden_size)
    llm, audio, vision = (LlamaForCausalLM(lcfg), jq.OmniAudioEncoder(acfg),
                          jq.OmniVisionEncoder(vcfg))
    S, patch = 16, vcfg.in_channels * vcfg.temporal_patch_size * vcfg.patch_size ** 2
    lp = random_params_like(llm, key, jnp.ones((1, 8), jnp.int32))
    ap = random_params_like(audio, key, jnp.zeros((1, 2 * acfg.n_window, acfg.num_mel_bins)),
                            jnp.asarray([4], jnp.int32), jnp.arange(2, dtype=jnp.int32))
    vp = random_params_like(vision, key, jnp.zeros((S, patch)), jnp.zeros((S, vcfg.head_dim // 2)),
                            jnp.zeros((S,), jnp.int32), jnp.zeros((S,), jnp.int32))
    return jq.QwenOmniThinker(llm, perturbed(unit_norms(lp), 3, scale=0.02), TinyTokenizer(),
                              audio, perturbed(unit_norms(ap), 1), vision,
                              perturbed(unit_norms(vp), 2), max_new_tokens=16)


@functools.lru_cache(maxsize=None)
def _pair():
    """(JAX thinker, port thinker) on the same perturbed weights."""
    jt = jax_tiny_thinker()
    acfg, vcfg, lcfg = jt.audio_enc.config, jt.vision_enc.config, jt.llm.config
    audio = load_jax_params(tq.OmniAudioEncoder(dataclasses.replace(
        tq.omni_audio_tiny(), output_dim=acfg.output_dim)), jt.audio_params).eval()
    vision = load_jax_params(tq.OmniVisionEncoder(dataclasses.replace(
        tq.omni_vision_tiny(), out_hidden_size=vcfg.out_hidden_size)), jt.vision_params).eval()
    llm = load_jax_params(L.LlamaForCausalLM(dataclasses.replace(
        tq.thinker_tiny_llm(), vocab_size=lcfg.vocab_size)), jt.llm_params).eval()
    return jt, tq.QwenOmniThinker(llm, TinyTokenizer(), audio, vision, max_new_tokens=16)


def _media():
    # 37 mel frames: chunks of 16, 16 and a ragged 5; a 24x40 image (6x10
    # patches, 3x5 merged: not a multiple of the 2x2 window); 3 video frames
    # (padded to 4)
    return ([_x((37, 16), 10)], [_x((24, 40, 3), 11)], [_x((3, 16, 16, 3), 12)])


class Recording(TinyTokenizer):
    """TinyTokenizer keeping the ids of its last decode (random ids past its
    259 decode to nothing, so the texts alone would agree too easily)."""

    def decode(self, ids, **kw):
        self.ids = list(ids)
        return super().decode(ids, **kw)


@functools.lru_cache(maxsize=None)
def _reference_chat():
    jt, _ = _pair()
    audios, images, videos = _media()
    jt.tokenizer = Recording()
    out = jt.chat(PROMPT, audios=audios, images=images, videos=videos,
                  return_talker_streams=True)
    return out, jt.tokenizer.ids


# ---- host helpers ---------------------------------------------------------------

@pytest.mark.parametrize("case", ["sinusoids", "chunks", "patchify", "windows", "mrope"])
def test_host_helpers_equal_the_reference(case):
    vcfg = jq.omni_vision_tiny()
    tcfg = tq.omni_vision_tiny()
    if case == "sinusoids":
        np.testing.assert_array_equal(tq.sinusoid_positions(50, 32),
                                      jq.sinusoid_positions(50, 32))
    elif case == "chunks":
        for t, n in ((37, 8), (32, 8), (1000, 100), (7, 8)):
            assert tq.audio_chunk_lengths(t, n) == jq.audio_chunk_lengths(t, n)
    elif case == "patchify":
        img = _x((24, 40, 3), 1)
        for got, want in ((tq.patchify_image(img, tcfg), jq.patchify_image(img, vcfg)),
                          (tq.patchify_video(_x((5, 16, 24, 3), 2), tcfg),
                           jq.patchify_video(_x((5, 16, 24, 3), 2), vcfg))):
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1]
        assert tq.patchify_video(_x((5, 16, 24, 3), 2), tcfg)[1] == (3, 4, 6)   # odd frames
    elif case == "windows":
        for grid in ((1, 6, 10), (3, 4, 6), (2, 8, 8)):
            for got, want in zip(tq.vision_window_meta(grid, tcfg),
                                 jq.vision_window_meta(grid, vcfg)):
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
        # full size: a 448 x 448 image is a 32 x 32 grid in 4 x 4 windows of merged tokens
        full = tq.vision_window_meta((1, 32, 32), tq.omni_vision_full())
        want = jq.vision_window_meta((1, 32, 32), jq.omni_vision_full())
        for g, w in zip(full, want):
            np.testing.assert_array_equal(g, w)
    else:
        segs = [("text", 5, None, 1.0), ("image", 0, (1, 6, 10), 1.0), ("audio", 4, None, 1.0),
                ("video", 0, (3, 4, 6), 0.5), ("text", 2, None, 1.0)]
        got = tq.build_mrope_positions([tq.MMSegment(*s) for s in segs])
        want = jq.build_mrope_positions([jq.MMSegment(*s) for s in segs])
        np.testing.assert_array_equal(got, want)


# ---- towers ---------------------------------------------------------------------

@pytest.mark.parametrize("frames", [37, 32])
def test_audio_tower_matches_jax(frames):
    jt, tt = _pair()
    mel = _x((frames, 16), frames)
    want = np.asarray(jq.encode_audio_host(jt.audio_enc, jt.audio_params, mel))
    got = tq.encode_audio_host(tt.audio_enc, mel).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("kind", ["image", "video"])
def test_vision_tower_matches_jax(kind):
    jt, tt = _pair()
    if kind == "image":
        want, wgrid = jt.encode_image(_x((24, 40, 3), 3))
        got, grid = tt.encode_image(_x((24, 40, 3), 3))
    else:
        want, wgrid = jt.encode_video(_x((3, 16, 24, 3), 4))
        got, grid = tt.encode_video(_x((3, 16, 24, 3), 4))
    assert grid == wgrid
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


# ---- the thinker ----------------------------------------------------------------

def test_chat_matches_jax_with_the_talker_streams():
    _, tt = _pair()
    (want_text, want), want_ids = _reference_chat()
    audios, images, videos = _media()
    tt.tokenizer = Recording()
    text, got = tt.chat(PROMPT, audios=audios, images=images, videos=videos,
                        return_talker_streams=True)
    assert text == want_text and tt.tokenizer.ids == want_ids and len(want_ids) == 17
    np.testing.assert_array_equal(got["positions"], np.asarray(want["positions"]))
    for k in ("prompt_stream", "reply_stream"):
        assert got[k].shape == np.asarray(want[k]).shape, k
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=0, err_msg=k)
    # 16 steps and no EOS: 17 tokens, 16 rows (the last token is never fed back)
    assert got["reply_stream"].shape[0] == tt.max_new_tokens
    assert tt.chat(PROMPT, audios=audios, images=images, videos=videos) == text


def test_chat_stops_at_eos_where_the_reference_cuts():
    # the same chat with EOS set to the 6th greedy token: the reference still
    # decodes every step and cuts; the port stops stepping there
    jt, tt = _pair()
    audios, images, videos = _media()

    rec = Recording()
    tt.tokenizer = rec
    try:
        tt.chat(PROMPT, audios=audios, images=images, videos=videos)
    finally:
        tt.tokenizer = TinyTokenizer()
    assert len(rec.ids) == 17

    class EosAt(TinyTokenizer):
        eos_token_id = rec.ids[5]

    class EosAtRecording(EosAt, Recording):
        pass

    jtok, ttok = EosAtRecording(), EosAtRecording()
    jt.tokenizer, tt.tokenizer = jtok, ttok
    try:
        want_text, want = jt.chat(PROMPT, audios=audios, images=images, videos=videos,
                                  return_talker_streams=True)
        got_text, got = tt.chat(PROMPT, audios=audios, images=images, videos=videos,
                                return_talker_streams=True)
    finally:
        jt.tokenizer, tt.tokenizer = TinyTokenizer(), TinyTokenizer()
    assert got_text == want_text and ttok.ids == jtok.ids
    assert len(got["reply_stream"]) == len(want["reply_stream"]) == rec.ids.index(rec.ids[5])
    np.testing.assert_allclose(got["reply_stream"], want["reply_stream"], atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", ["no_input", "no_marker"])
def test_chat_refuses_unmatched_inputs(case):
    _, tt = _pair()
    with pytest.raises(ValueError, match="no matching input" if case == "no_input"
                       else "refusing to silently drop"):
        if case == "no_input":
            tt.chat("look <IMAGE-Placeholder>")
        else:
            tt.chat("look", images=[_x((8, 8, 3), 0)])


# ---- rule sets --------------------------------------------------------------------

def _tower_cfgs():
    """(JAX, port) configs at the manifests' depths (32 layers, full
    attention at 7/15/23/31) and tiny widths."""
    ja = jq.OmniAudioConfig(num_mel_bins=16, d_model=32, num_layers=32, num_heads=4, ffn_dim=64,
                            n_window=8, max_positions=64, output_dim=48)
    jv = jq.OmniVisionConfig(depth=32, hidden_size=32, intermediate_size=64, num_heads=4,
                             patch_size=4, window_size=16, out_hidden_size=48)
    ta = tq.OmniAudioConfig(**{f.name: getattr(ja, f.name) for f in dataclasses.fields(ja)
                               if f.name != "dtype"})
    tv = tq.OmniVisionConfig(**{f.name: getattr(jv, f.name) for f in dataclasses.fields(jv)
                                if f.name != "dtype"})
    return ja, jv, ta, tv


def _filled(module, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for t in module.state_dict().values():
            t.copy_(torch.randn(t.shape, generator=gen))
    return module


# a Qwen2 decoder as wide as the manifests' towers put out (48)
_LLM_WIDTHS = dict(vocab_size=320, hidden_size=48, intermediate_size=64, num_attention_heads=4,
                   num_key_value_heads=2, mrope_section=(2, 2, 2))


@functools.lru_cache(maxsize=None)
def _thinker_sd(prefixed: bool):
    """A thinker state dict with the manifests' tower keys (and the key the
    converters skip), a Qwen2 decoder's keys, and, prefixed, a talker key
    that the thinker rules must leave alone."""
    _, _, ta, tv = _tower_cfgs()
    lcfg = dataclasses.replace(tq.thinker_tiny_llm(), **_LLM_WIDTHS)
    sd = {}
    for pre, module, rules_fn in (
            ("audio_tower.", tq.OmniAudioEncoder(ta), TC.omni_audio_rules),
            ("visual.", tq.OmniVisionEncoder(tv), TC.omni_vision_rules)):
        rules = rules_fn(_manifest("omni_" + ("audio_tower" if pre == "audio_tower." else
                                              "vision_tower")), module.config, prefix="")
        part = TC.export_state_dict(rules, _filled(module, len(pre)).state_dict())
        sd.update({pre + k: v for k, v in part.items()})
    sd["audio_tower.audio_bos_eos_token.weight"] = torch.randn(2, 32)
    llm = _filled(L.LlamaForCausalLM(lcfg), 7)
    sd.update(TC.export_state_dict(TC.llama_rules({"lm_head.weight"}, lcfg), llm.state_dict()))
    if prefixed:
        sd = {"thinker." + k: v for k, v in sd.items()}
        sd["talker.codec_head.weight"] = torch.zeros(4, 4)
    return {k: v.numpy() for k, v in sd.items()}, lcfg


@pytest.mark.parametrize("prefixed", [False, True], ids=["bare", "thinker"])
def test_thinker_rules_match_the_reference_converter_bit_for_bit(prefixed):
    ja, jv, ta, tv = _tower_cfgs()
    sd, lcfg = _thinker_sd(prefixed)
    jl = dataclasses.replace(jq.thinker_tiny_llm(), **_LLM_WIDTHS)
    ref = JC.convert_omni_thinker(sd, ja, jv, jl)
    rules = TC.omni_thinker_rules(sd, ta, tv, lcfg)
    for make, rset, tree in ((lambda: tq.OmniAudioEncoder(ta), rules[0], ref[0]),
                             (lambda: tq.OmniVisionEncoder(tv), rules[1], ref[1]),
                             (lambda: L.LlamaForCausalLM(lcfg), rules[2], ref[2])):
        want = load_jax_params(make(), _np_tree(tree))
        got = make()
        got.load_state_dict(TC.convert_state_dict(rset, sd), strict=True)
        _assert_same_state(got, want)
    read = {k for r in rules for rule in r for k in rule.keys}
    pre = "thinker." if prefixed else ""
    assert read == {k for k in sd if k.startswith(pre)} - {
        pre + "audio_tower.audio_bos_eos_token.weight"}


@pytest.mark.parametrize("name", ["omni_audio_tower", "omni_vision_tower"])
def test_full_towers_read_exactly_the_manifest(name):
    keys = set(_manifest(name))
    if name == "omni_audio_tower":
        module = tq.OmniAudioEncoder(tq.omni_audio_full(), "meta")
        rules = TC.omni_audio_rules(keys, module.config, prefix="")
        skipped = {"audio_bos_eos_token.weight"}
    else:
        module = tq.OmniVisionEncoder(tq.omni_vision_full(), "meta")
        rules = TC.omni_vision_rules(keys, module.config, prefix="")
        skipped = set()
    read = [k for r in rules for k in r.keys]
    filled = [n for r in rules for n in r.names]
    assert len(read) == len(set(read)) and len(filled) == len(set(filled))
    assert set(read) == keys - skipped
    assert set(filled) == set(module.state_dict())


def test_thinker_from_a_checkpoint_directory(tmp_path, monkeypatch):
    # from_pretrained('qwen_omni_thinker', path=...) at test widths: the full
    # presets swapped for the manifests' tower widths and a tiny Qwen2, the
    # depths cut through config.json (4 audio layers, 3 vision blocks, 2 decoder layers)
    sd, lcfg = _thinker_sd(True)
    _, _, ta, tv = _tower_cfgs()
    monkeypatch.setattr(tq, "omni_audio_full", lambda: ta)
    monkeypatch.setattr(tq, "omni_vision_full", lambda: tv)
    monkeypatch.setattr(tq, "thinker_llm_full", lambda: lcfg)
    keep = lambda k: not any(f".{s}.{i}." in k for s in ("layers", "blocks")
                             for i in range(4, 32)) and ".blocks.3." not in k
    io.save_file({k: torch.from_numpy(v) for k, v in sd.items() if keep(k)},
                 str(tmp_path / "model.safetensors"))
    with open(tmp_path / "config.json", "w") as f:
        json.dump({"thinker_config": {"text_config": {"num_hidden_layers": 2},
                                      "audio_config": {"encoder_layers": 4},
                                      "vision_config": {"depth": 3}},
                   "talker_config": {"num_hidden_layers": 2}}, f)
    assert TC.read_omni_config(str(tmp_path)) == dict(
        llm=dict(num_hidden_layers=2), audio=dict(num_layers=4), vision=dict(depth=3),
        talker=dict(num_hidden_layers=2))
    thinker = factory.from_pretrained("qwen_omni_thinker", path=str(tmp_path), device="cpu",
                                      dtype=torch.float32)
    assert isinstance(thinker, tq.QwenOmniThinker) and isinstance(thinker.tokenizer, TinyTokenizer)
    assert thinker.vision_enc.config.fullatt_block_indexes == ()
    for module, rules in zip((thinker.audio_enc, thinker.vision_enc, thinker.llm),
                             TC.omni_thinker_rules(sd, thinker.audio_enc.config,
                                                   thinker.vision_enc.config,
                                                   thinker.llm.config)):
        want = TC.convert_state_dict(rules, sd)
        state = module.state_dict()
        assert sorted(state) == sorted(want)
        for k, v in want.items():
            assert torch.equal(state[k], v.to(state[k].dtype)), k
    thinker.max_new_tokens = 4
    out = thinker.chat("hello <IMAGE-Placeholder>", images=[_x((16, 16, 3), 5)])
    assert isinstance(out, str)
