"""Parity of the PyTorch port's ops and copied modules with the JAX package.

Inputs are made with numpy from a seed and fed to both packages on the CPU
in fp32. Tolerances: plain-vs-plain attention, norms and RoPE compute the
same fp32 formulas in another summation order, so 1e-5; against the Pallas
kernel in interpret mode, 2e-3 (the tolerance tests/test_ops.py holds that
kernel to, since it rounds P to the value dtype blockwise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spider_tpu.common import config as jconfig
from spider_tpu.common import registry as jregistry
from spider_tpu.models import spider_decoder as jdec
from spider_tpu.models import tags as jtags
from spider_tpu.models import tokenizer as jtok
from spider_tpu.ops import attention as jattn
from spider_tpu.ops import norms as jnorms
from spider_tpu.ops import rope as jrope
from spider_tpu.ops import sampling as jsampling
from spider_tpu_torch.common import config as tconfig
from spider_tpu_torch.common import registry as tregistry
from spider_tpu_torch.models import spider_decoder as tdec
from spider_tpu_torch.models import tags as ttags
from spider_tpu_torch.models import tokenizer as ttok
from spider_tpu_torch.ops import attention as tattn
from spider_tpu_torch.ops import norms as tnorms
from spider_tpu_torch.ops import rope as trope
from spider_tpu_torch.ops import sampling as tsampling


def _randn(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


def _qkv(seed, B, T, S, Hq, Hkv, D):
    rng = np.random.default_rng(seed)
    return _randn(rng, B, T, Hq, D), _randn(rng, B, S, Hkv, D), _randn(rng, B, S, Hkv, D)


def _conv_kwargs(conv, B, S):
    """The three position conventions of flash_attention, as numpy."""
    if conv == "suffix":
        return {}
    kw = dict(kv_len=np.array([S - 5, S][:B], np.int32))
    if conv == "q_offset":
        kw["q_offset"] = np.array([3, 9][:B], np.int32)
    return kw


@pytest.mark.parametrize("conv", ["suffix", "kv_len", "q_offset"])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("D", [40, 64, 128])
def test_plain_attention_matches_jax(conv, group, D):
    B, T, S, Hkv = 2, 12, 20, 2
    q, k, v = _qkv(D + group, B, T, S, Hkv * group, Hkv, D)
    kw = _conv_kwargs(conv, B, S)
    want = jattn.mha_reference(q, k, v, causal=True,
                               **{n: jnp.asarray(a) for n, a in kw.items()})
    got = tattn.mha_reference(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              causal=True, **{n: torch.from_numpy(a) for n, a in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_attention_with_lse_matches_jax(causal):
    B, T, S = 2, 9, 17
    q, k, v = _qkv(7, B, T, S, 4, 2, 64)
    kw = _conv_kwargs("q_offset", B, S)
    want_o, want_l = jattn.mha_reference_with_lse(
        q, k, v, causal=causal, **{n: jnp.asarray(a) for n, a in kw.items()})
    got_o, got_l = tattn.mha_reference_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal,
        **{n: torch.from_numpy(a) for n, a in kw.items()})
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=1e-5, rtol=0)


@pytest.mark.parametrize("causal,group,D,kv", [(True, 4, 128, False), (False, 1, 64, True),
                                               (True, 1, 64, True)])
def test_plain_attention_matches_pallas_interpret(causal, group, D, kv):
    from jax.experimental.pallas import tpu as pltpu

    B, T, Hkv = 1, 256, 2
    q, k, v = _qkv(11, B, T, T, Hkv * group, Hkv, D)
    kv_len = np.array([200], np.int32) if kv else None
    with pltpu.force_tpu_interpret_mode():
        want, want_lse = jattn._flash_forward(
            q, k, v, causal, D ** -0.5, None if kv_len is None else jnp.asarray(kv_len),
            None, 128, 128)
    t = lambda a: None if a is None else torch.from_numpy(a)
    got, got_lse = tattn.flash_attention_with_lse(t(q), t(k), t(v), causal=causal,
                                                  kv_len=t(kv_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse)[..., 0], atol=2e-3,
                               rtol=2e-3)


def test_flash_wrapper_on_cpu_takes_plain_path():
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 1, 8, 8, 2, 2, 40))
    before = tattn.flash_attention.launches
    got = tattn.flash_attention(q, k, v, causal=True)
    out, lse = tattn.flash_attention_with_lse(q, k, v, causal=True)
    assert tattn.flash_attention.launches == before
    torch.testing.assert_close(got, tattn.mha_reference(q, k, v, causal=True), atol=0, rtol=0)
    # The with-lse form normalises by an explicit sum: equal to 1 ulp.
    torch.testing.assert_close(out, got, atol=1e-6, rtol=0)
    assert lse.shape == (1, 2, 8)


def test_rms_and_layer_norm_match_jax():
    rng = np.random.default_rng(0)
    x, w, b = _randn(rng, 3, 5, 16), _randn(rng, 16) + 1.0, _randn(rng, 16)
    np.testing.assert_allclose(
        tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy(),
        np.asarray(jnorms.rms_norm(x, w, 1e-5)), atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        tnorms.layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)).numpy(),
        np.asarray(jnorms.layer_norm(x, w, b)), atol=1e-5, rtol=0)


@pytest.mark.parametrize("scaling", [None, dict(factor=8.0, low_freq_factor=1.0,
                                                high_freq_factor=4.0,
                                                original_max_position_embeddings=8192)])
def test_rope_matches_jax(scaling):
    inv_j = jrope.rope_inv_freq(128, 500000.0, scaling)
    inv_t = trope.rope_inv_freq(128, 500000.0, scaling)
    np.testing.assert_allclose(inv_t.numpy(), np.asarray(inv_j), rtol=1e-6, atol=0)
    rng = np.random.default_rng(1)
    x = _randn(rng, 2, 7, 4, 128)
    pos = rng.integers(0, 4000, size=(2, 7)).astype(np.int32)
    want = jrope.apply_rope(x, pos, inv_j)
    got = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), inv_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_sampling_greedy_matches_jax_and_top_p_uses_generator():
    rng = np.random.default_rng(2)
    logits = _randn(rng, 4, 50)
    np.testing.assert_array_equal(tsampling.greedy(torch.from_numpy(logits)).numpy(),
                                  np.asarray(jsampling.greedy(logits)))
    lt = torch.from_numpy(logits)
    draw = lambda seed: tsampling.sample_top_p(
        lt, torch.Generator().manual_seed(seed), temperature=1.0, top_p=0.9)
    torch.testing.assert_close(draw(5), draw(5))
    with pytest.raises(ValueError, match="Generator"):
        tsampling.sample_top_p(lt, None, temperature=1.0)
    # A nucleus narrower than the top token keeps exactly the argmax.
    np.testing.assert_array_equal(
        tsampling.sample_top_p(lt, torch.Generator().manual_seed(0), temperature=1.0,
                               top_p=1e-6).numpy(), np.asarray(jsampling.greedy(logits)))


# --------------------------------------------------------------------------
# The copied framework-free modules behave like their originals.
# --------------------------------------------------------------------------

TAG_TEXTS = [
    "Beijing<IMAGE>The Great Wall</IMAGE> and <VIDEO>Dragon\nDance</VIDEO>, <AUDIO>a</AUDIO>",
    "<think>plan <IMAGE>no</IMAGE></think>Dog<MASK>Dog</MASK>, Dog<BOX>Dog</BOX>.",
    "<IMAGESTORY><GENERALPROMPT>'an alien'</GENERALPROMPT>, <PROMPTARRAY>['lands', "
    "'meets a child']</PROMPTARRAY>, <STYLENAME>'Comic book'</STYLENAME></IMAGESTORY>",
    "<IMAGESTORY><PROMPTARRAY>[\"a\", \"b\"]</PROMPTARRAY><STYLENAME>Photographic"
    "</STYLENAME></IMAGESTORY> <IMAGE>unclosed",
]


@pytest.mark.parametrize("text", TAG_TEXTS)
def test_tags_copy_matches_original(text):
    for m in jtags.MODALITY_KEYS:
        assert ttags.get_llm_text_res(text, m) == jtags.get_llm_text_res(text, m)
    assert ttags.get_llm_text_modality(text) == jtags.get_llm_text_modality(text)
    assert ttags.strip_think(text) == jtags.strip_think(text)
    assert ttags.extract_story_elements(text) == jtags.extract_story_elements(text)
    assert ttags.clean_prompt_array(text) == jtags.clean_prompt_array(text)
    assert (ttags.split_on_placeholders(text, ["IMAGE", "VIDEO"])
            == jtags.split_on_placeholders(text, ["IMAGE", "VIDEO"]))


def test_tiny_tokenizer_copy_matches_original():
    j, t = jtok.TinyTokenizer(), ttok.TinyTokenizer()
    jtok.extend_tokenizer(j, bbox_bins=8)
    jtok.extend_tokenizer(t, bbox_bins=8)    # the JAX helper drives either copy
    assert len(j) == len(t)
    text = "héllo <IMAGE>[IMAGE0] a cat</IMAGE> <Loc3>[END]"
    assert t.encode(text) == j.encode(text)
    assert t(text).input_ids == j(text).input_ids
    batch_j = j(["a", "bcd"], padding=True)
    batch_t = t(["a", "bcd"], padding=True)
    assert batch_t.input_ids == batch_j.input_ids
    assert batch_t.attention_mask == batch_j.attention_mask
    ids = j.encode(text) + [0, 2, 9999]
    for skip in (True, False):
        assert t.decode(ids, skip_special_tokens=skip) == j.decode(ids, skip_special_tokens=skip)
    for tok in ("[END]", "<pad>", "a", "ab"):
        assert t.convert_tokens_to_ids(tok) == j.convert_tokens_to_ids(tok)


def _run_decoder(mod, text):
    calls = []

    def image(prompt, **kw):
        calls.append(("IMAGE", prompt, sorted(kw.items())))
        return [np.full((2, 2, 3), len(prompt[0]), np.float32)]

    def video(prompt, **kw):
        calls.append(("VIDEO", prompt, sorted(kw.items())))
        return np.zeros((2, 2, 2, 3), np.float32)

    dec = mod.SpiderDecoder(decoders=dict(IMAGE=image, VIDEO=video),
                            decode_options=dict(IMAGE=dict(eta=0.5)))
    answers, preds, preds_text = dec.generate(
        dict(llm_text_all=[text]), [], mod.empty_predictions(), mod.empty_predictions_text())
    return calls, answers, preds_text, [np.asarray(p).tolist() for p in preds["IMAGE"]]


@pytest.mark.parametrize("text", TAG_TEXTS[:2])
def test_spider_decoder_copy_matches_original(text):
    assert _run_decoder(tdec, text) == _run_decoder(jdec, text)
    assert tregistry.registry.get_model_class("spider_decoder") is tdec.SpiderDecoder


def test_registry_and_config_copies_match_originals(tmp_path):
    for mod in (jregistry, tregistry):
        reg = mod.Registry()
        reg.register_model("m")(int)
        with pytest.raises(KeyError):
            reg.register_model("m")(float)
        reg.register_path("p", "/x")
        assert (reg.get_model_class("m"), reg.list_models(), reg.get_path("p")) \
            == (int, ["m"], "/x")
    path = tmp_path / "cfg.py"
    path.write_text("model = dict(type='spider_decoder', a=dict(b=1))\nrun = [1, 2]\n")
    cj = jconfig.apply_overrides(jconfig.Config.fromfile(str(path)), ["model.a.c=3", "run=[4]"])
    ct = tconfig.apply_overrides(tconfig.Config.fromfile(str(path)), ["model.a.c=3", "run=[4]"])
    assert ct.to_dict() == cj.to_dict()
    assert ct.model.a.c == 3
    assert ct.merge(dict(model=dict(x=1))).to_dict() == cj.merge(dict(model=dict(x=1))).to_dict()
