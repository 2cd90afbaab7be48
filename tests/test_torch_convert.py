"""The port's HF/diffusers converters (spider_tpu_torch/models/convert.py)
against the JAX package's, and the checkpoint entry points built on them.

Parity: the reference's own emitters (tests/test_convert.py,
tests/test_convert_diffusion.py) make a state dict in the checkpoint's
layout at a tiny width; the reference converter plus ``load_jax_params``
fills one port module, the port's converter plus
``load_state_dict(strict=True)`` another, and every tensor must be equal bit
for bit in fp32 (int8 ``kernel_q``/``kernel_scale`` included; the
weight-norm fold runs the reference's numpy code, so it is bit-equal too).
Key sets: the checkpoint keys the port reads at each full preset equal the
recorded key list of the real checkpoint (tests/fixtures/convert_keys/),
and the names it fills equal the full module's state dict (built on the
meta device, so without tensors). End to end: tiny HF and diffusers
directories on disk through ``from_pretrained(kind, path=...)``,
``load_or_init_llm`` and ``build_full_spider(paths=...)``.
"""

import dataclasses
import functools
import json
import os
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spider_tpu.models import clip_text as jclip
from spider_tpu.models import convert as JC
from spider_tpu.models import imagebind as jib
from spider_tpu.models import llama as jL
from spider_tpu.models import photomaker as jpm
from spider_tpu.models import tokenizer as jtok
from spider_tpu.models import unet2d as junet
from spider_tpu.models import unet3d as junet3d
from spider_tpu.models import vae as jvae
from spider_tpu.models import vocoder as jvoc
from spider_tpu_torch.models import checkpoint_io as io
from spider_tpu_torch.models import clip_text as tclip
from spider_tpu_torch.models import convert as TC
from spider_tpu_torch.models import factory
from spider_tpu_torch.models import imagebind as tib
from spider_tpu_torch.models import llama as tL
from spider_tpu_torch.models import photomaker as tpm
from spider_tpu_torch.models import tokenizer as ttok
from spider_tpu_torch.models import unet2d as tunet
from spider_tpu_torch.models import unet3d as tunet3d
from spider_tpu_torch.models import vae as tvae
from spider_tpu_torch.models import vocoder as tvoc
from spider_tpu_torch.models.convert import load_jax_params
from test_convert import _fake_llama_sd, make_clip_sd
from test_convert_diffusion import (make_clap_sd, make_hifigan_sd, make_imagebind_sd,
                                    make_photomaker_sd, make_unet2d_sd, make_unet3d_sd,
                                    make_vae_sd)

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "convert_keys")


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _assert_same_state(a, b, cast=False):
    """Every tensor of module `a` equals `b`'s bit for bit (with `cast`,
    `b`'s cast to `a`'s dtype)."""
    sa, sb = a.state_dict(), b.state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        want = sb[k].to(sa[k].dtype) if cast else sb[k]
        assert sa[k].dtype == want.dtype and sa[k].shape == want.shape, k
        assert torch.equal(sa[k], want), k


def _hifigan_weight_normed(sd):
    """Every conv weight of a HiFi-GAN state dict as weight_g / weight_v,
    the norm over all axes but the first (torch's weight_norm, dim 0), each
    C-contiguous as a checkpoint's tensors are (numpy's sum order follows
    the memory layout)."""
    out = {}
    for k, v in sd.items():
        if k.endswith(".weight"):
            v = np.ascontiguousarray(v, np.float32)
            g = np.sqrt((v ** 2).sum(axis=tuple(range(1, v.ndim)), keepdims=True))
            out[k[:-7] + ".weight_g"] = (1.5 * g).astype(np.float32)   # not the identity
            out[k[:-7] + ".weight_v"] = v
        else:
            out[k] = v
    return out


def _llama_case(quantize):
    jcfg = dataclasses.replace(jL.llama_tiny(vocab_size=128), quantization=quantize)
    tcfg = dataclasses.replace(tL.llama_tiny(vocab_size=128), quantization=quantize)
    sd = _fake_llama_sd(jcfg, np.random.default_rng(0))
    return (sd, lambda: JC.convert_llama_state_dict(sd, jcfg, quantize),
            lambda: TC.convert_llama_state_dict(sd, tcfg, quantize),
            lambda: tL.LlamaForCausalLM(tcfg, "cpu"))


# The tiny text_time UNet of build_tiny_sdxl: a context of 32 + 48 and the
# pooled 48 beside six time ids of 8.
TINY_SDXL_UNET = dict(cross_attention_dim=80, addition_embed_type="text_time", projection_dim=96)


@functools.lru_cache(maxsize=None)
def _family_case(name):
    """(state dict, reference tree, port state dict, a function making an
    empty port module); made once per process (the JAX emitters take
    seconds), so callers must not change them."""
    if name in ("llama", "llama_int8"):
        sd, ref, port, make = _llama_case("int8" if name == "llama_int8" else None)
        return sd, ref(), port(), make
    if name == "clip":
        jcfg, tcfg = jclip.clip_tiny(100), tclip.clip_tiny(100)
        sd = make_clip_sd(jcfg)
        return (sd, JC.convert_clip_text_state_dict(sd, jcfg),
                TC.convert_clip_text_state_dict(sd, tcfg),
                lambda: tclip.CLIPTextModel(tcfg, "cpu"))
    if name == "clip_bigg":          # a projected tanh-GELU encoder, SDXL's second's form
        wide = dict(hidden_size=48, intermediate_size=96, projection_dim=48, hidden_act="gelu")
        jcfg = dataclasses.replace(jclip.clip_tiny(100), **wide)
        tcfg = dataclasses.replace(tclip.clip_tiny(100), **wide)
        sd = make_clip_sd(jcfg)
        return (sd, JC.convert_clip_text_state_dict(sd, jcfg),
                TC.convert_clip_text_state_dict(sd, tcfg),
                lambda: tclip.CLIPTextModel(tcfg, "cpu"))
    if name == "clap":
        jcfg, tcfg = jclip.clap_tiny(300), tclip.clap_tiny(300)
        sd = make_clap_sd(jcfg)[0]
        return (sd, JC.convert_clap_text_state_dict(sd, jcfg),
                TC.convert_clap_text_state_dict(sd, tcfg),
                lambda: tclip.ClapTextModel(tcfg, "cpu"))
    if name == "vae":
        jcfg, tcfg = jvae.vae_tiny(), tvae.vae_tiny()
        sd = make_vae_sd(jcfg)[0]
        return (sd, JC.convert_vae_state_dict(sd, jcfg), TC.convert_vae_state_dict(sd, tcfg),
                lambda: tvae.AutoencoderKL(tcfg, "cpu"))
    if name in ("unet_sd", "unet_audioldm", "unet_sdxl"):
        kw = {"unet_sd": {}, "unet_audioldm": dict(
            cross_attention_dim=16, addition_embed_type="class_embed", projection_dim=16),
            "unet_sdxl": TINY_SDXL_UNET}[name]
        jcfg, tcfg = junet.unet_tiny(**kw), tunet.unet_tiny(**kw)
        sd = make_unet2d_sd(jcfg)[0]
        return (sd, JC.convert_unet2d_state_dict(sd, jcfg),
                TC.convert_unet2d_state_dict(sd, tcfg),
                lambda: tunet.UNet2DConditionModel(tcfg, "cpu"))
    if name == "unet3d":
        jcfg, tcfg = junet3d.unet3d_tiny(), tunet3d.unet3d_tiny()
        sd = make_unet3d_sd(jcfg)[0]
        return (sd, JC.convert_unet3d_state_dict(sd, jcfg),
                TC.convert_unet3d_state_dict(sd, tcfg),
                lambda: tunet3d.UNet3DConditionModel(tcfg, "cpu"))
    if name in ("hifigan", "hifigan_weight_norm"):
        jcfg, tcfg = jvoc.hifigan_tiny(), tvoc.hifigan_tiny()
        sd = make_hifigan_sd(jcfg)[0]
        if name == "hifigan_weight_norm":
            sd = _hifigan_weight_normed(sd)
        return (sd, JC.convert_hifigan_state_dict(sd, jcfg),
                TC.convert_hifigan_state_dict(sd, tcfg), lambda: tvoc.HifiGan(tcfg, "cpu"))
    if name == "photomaker":
        jcfg, tcfg = jpm.photomaker_tiny(), tpm.photomaker_tiny()
        sd = make_photomaker_sd(jcfg)[0]
        return (sd, JC.convert_photomaker_state_dict(sd, jcfg),
                TC.convert_photomaker_state_dict(sd, tcfg),
                lambda: tpm.PhotoMakerIDEncoder(tcfg, "cpu"))
    if name == "imagebind":
        jcfg, tcfg = jib.imagebind_tiny(), tib.imagebind_tiny()
        sd = make_imagebind_sd(jcfg)[0]
        return (sd, JC.convert_imagebind_state_dict(sd, jcfg),
                TC.convert_imagebind_state_dict(sd, tcfg),
                lambda: tib.ImageBindEncoder(tcfg, "cpu"))
    raise KeyError(name)


FAMILIES = ("llama", "llama_int8", "clip", "clip_bigg", "clap", "vae", "unet_sd",
            "unet_audioldm", "unet_sdxl", "unet3d", "hifigan", "hifigan_weight_norm",
            "imagebind", "photomaker")


@pytest.mark.parametrize("name", FAMILIES)
def test_port_converter_matches_reference_bit_for_bit(name):
    sd, ref_tree, port_state, make = _family_case(name)
    want = load_jax_params(make(), _np_tree(ref_tree))
    got = make()
    got.load_state_dict(port_state, strict=True)
    _assert_same_state(got, want)
    if name == "llama_int8":
        assert got.model.layers[0].self_attn.q_proj.kernel_q.dtype == torch.int8
    if name == "hifigan_weight_norm":
        assert not any(k.endswith(".weight") for k in sd)


def test_streamed_load_matches_the_eager_converter(tmp_path):
    # The same rules through load_converted from a file on disk, and the
    # reference's 1x1-conv form of a dense weight ([out, in, 1, 1]).
    sd, _, port_state, make = _family_case("unet_sd")
    module = make()
    sd = {k: (v[:, :, None, None] if k.endswith(("proj_in.weight", "proj_out.weight"))
              and np.ndim(v) == 2 else v) for k, v in sd.items()}
    assert any(np.ndim(v) == 4 and v.shape[2:] == (1, 1) and "proj_in" in k
               for k, v in sd.items())
    io.save_file({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                 str(tmp_path / "diffusion_pytorch_model.safetensors"))
    TC.load_checkpoint(module, TC.unet2d_rules, str(tmp_path))
    ref = tunet.UNet2DConditionModel(tunet.unet_tiny(), "cpu")
    ref.load_state_dict(port_state, strict=True)
    _assert_same_state(module, ref)
    jcfg = junet.unet_tiny()
    ref_tree = JC.convert_unet2d_state_dict(sd, jcfg)
    _assert_same_state(module, load_jax_params(
        tunet.UNet2DConditionModel(tunet.unet_tiny(), "cpu"), _np_tree(ref_tree)))


def test_loader_raises_on_missing_key_unknown_name_shape_and_unfilled():
    sd = _family_case("vae")[0]
    cfg = tvae.vae_tiny()
    rules = TC.vae_rules(sd, cfg)
    with pytest.raises(KeyError, match="encoder.conv_in.weight"):
        TC.load_converted(tvae.AutoencoderKL(cfg, "cpu"), rules,
                          {k: v for k, v in sd.items() if k != "encoder.conv_in.weight"})
    bad = dict(sd)
    bad["encoder.conv_in.weight"] = np.zeros((1, 1, 3, 3), np.float32)
    with pytest.raises(ValueError, match="encoder.conv_in.weight"):
        TC.load_converted(tvae.AutoencoderKL(cfg, "cpu"), rules, bad)
    with pytest.raises(KeyError, match="has no"):
        TC.load_converted(tvae.AutoencoderKL(cfg, "cpu"),
                          rules + [TC.Rule(("nowhere.weight",), ("quant_conv.weight",))], sd)
    with pytest.raises(KeyError, match="not filled"):
        TC.load_converted(tvae.AutoencoderKL(cfg, "cpu"), rules[:-1], sd)
    with pytest.raises(ValueError, match="1x1"):
        TC.apply_rule(TC.Rule(("w",), ("k",), "linear"), [torch.zeros(2, 2, 3, 3)])


def test_extend_llama_embeddings_rows_match_reference():
    jcfg, tcfg = jL.llama_tiny(vocab_size=64), tL.llama_tiny(vocab_size=64)
    sd = _fake_llama_sd(jcfg, np.random.default_rng(1))
    ref = JC.extend_llama_embeddings(JC.convert_llama_state_dict(sd, jcfg), 200)["params"]
    got = TC.extend_llama_embeddings(TC.convert_llama_state_dict(sd, tcfg), 200)
    emb, head = np.asarray(ref["embed_tokens"]["embedding"]), np.asarray(ref["lm_head"]["kernel"])
    assert got["embed_tokens.weight"].shape == got["lm_head.weight"].shape == (200, 64)
    np.testing.assert_array_equal(got["embed_tokens.weight"].numpy(), emb)
    np.testing.assert_array_equal(got["lm_head.weight"].numpy(), head.T)
    same = TC.extend_llama_embeddings(TC.convert_llama_state_dict(sd, tcfg), 64)
    assert same["embed_tokens.weight"].shape == (64, 64)


# ---- key sets at the full presets ------------------------------------------

def _manifest(name):
    with open(os.path.join(FIXDIR, f"{name}.txt")) as f:
        return [line for line in f.read().splitlines() if line]


def _full_case(name):
    """(rules function, full port config, module on the meta device)."""
    if name == "llama3_8b":
        cfg = tL.llama3_8b()
        return TC.llama_rules, cfg, tL.LlamaForCausalLM(cfg, "meta")
    if name in ("clip_vit_l14", "clip_vit_h14", "clip_bigg"):
        cfg = tclip.open_clip_bigg() if name == "clip_bigg" else getattr(tclip, name)()
        return TC.clip_text_rules, cfg, tclip.CLIPTextModel(cfg, "meta")
    if name == "clap_text":
        cfg = tclip.ClapTextConfig()
        return TC.clap_text_rules, cfg, tclip.ClapTextModel(cfg, "meta")
    if name in ("vae_sd", "vae_audioldm"):
        cfg = getattr(tvae, name)()
        return TC.vae_rules, cfg, tvae.AutoencoderKL(cfg, "meta")
    if name in ("unet_sd15", "unet_audioldm", "unet_sdxl"):
        cfg = getattr(tunet, name)()
        return TC.unet2d_rules, cfg, tunet.UNet2DConditionModel(cfg, "meta")
    if name == "unet3d_zeroscope":
        cfg = tunet3d.unet3d_zeroscope()
        return TC.unet3d_rules, cfg, tunet3d.UNet3DConditionModel(cfg, "meta")
    if name == "hifigan_audioldm":
        cfg = tvoc.hifigan_audioldm()
        return TC.hifigan_rules, cfg, tvoc.HifiGan(cfg, "meta")
    if name == "imagebind_huge":
        cfg = tib.imagebind_huge()
        return TC.imagebind_rules, cfg, tib.ImageBindEncoder(cfg, "meta")
    if name == "photomaker_v1":
        cfg = tpm.photomaker_v1()
        return TC.photomaker_rules, cfg, tpm.PhotoMakerIDEncoder(cfg, "meta")
    raise KeyError(name)


# Keys a real checkpoint may hold beside the manifest's, which no converter
# reads (buffers the modules recompute): none of these families' manifests
# lists one, and the port ignores them as the reference does.
KNOWN_EXTRAS = ("model.layers.0.self_attn.rotary_emb.inv_freq",
                "text_model.embeddings.position_ids", "embeddings.position_ids")

MANIFESTS = ("llama3_8b", "clip_vit_l14", "clip_vit_h14", "clip_bigg", "clap_text", "vae_sd",
             "vae_audioldm", "unet_sd15", "unet_audioldm", "unet_sdxl", "unet3d_zeroscope",
             "hifigan_audioldm", "imagebind_huge", "photomaker_v1")


@pytest.mark.parametrize("name", MANIFESTS)
def test_full_preset_reads_exactly_the_manifest(name):
    keys = set(_manifest(name))
    rules_fn, cfg, module = _full_case(name)
    rules = rules_fn(keys | set(KNOWN_EXTRAS), cfg)
    read = [k for r in rules for k in r.keys]
    filled = [n for r in rules for n in r.names]
    assert len(read) == len(set(read)) and len(filled) == len(set(filled))
    assert set(read) == keys
    assert set(filled) == set(module.state_dict())
    state = module.state_dict()
    if name == "llama3_8b":
        assert tuple(state["model.layers.31.mlp.down_proj.weight"].shape) == (4096, 14336)
        qrules = TC.llama_rules(keys, dataclasses.replace(cfg, quantization="int8"), "int8")
        qmod = tL.LlamaForCausalLM(dataclasses.replace(cfg, quantization="int8"), "meta")
        assert {n for r in qrules for n in r.names} == set(qmod.state_dict())
    if name == "unet_sdxl":             # text_time, and the mid block's 10 blocks
        assert tuple(state["add_embed_1.weight"].shape) == (1280, 2816)
        assert "mid_attn.block_9.attn1.to_q.weight" in state
    if name == "photomaker_v1":
        assert tuple(state["vision_model.position_embedding"].shape) == (257, 1024)
    if name == "hifigan_audioldm":      # the weight-normed form reads the pairs
        normed = {k[:-7] + s for k in keys if k.endswith(".weight")
                  for s in (".weight_g", ".weight_v")}
        normed |= {k for k in keys if not k.endswith(".weight")}
        assert {k for r in rules_fn(normed, cfg) for k in r.keys} == normed


# ---- the llama checkpoint entry points -------------------------------------

def _write_tiny_llama_dir(path, tied=False, extra=None):
    """A tiny HF Llama directory: config.json of llama_tiny's width, two
    safetensors shards with their index, the reference emitter's weights."""
    jcfg = jL.llama_tiny(vocab_size=300)
    sd = _fake_llama_sd(jcfg, np.random.default_rng(7))
    hf = dict(model_type="llama", vocab_size=300, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
              max_position_embeddings=512, rms_norm_eps=1e-5, rope_theta=10000.0,
              rope_scaling=None, tie_word_embeddings=tied, torch_dtype="float32")
    hf.update(extra or {})
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f)
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    keys = sorted(tensors)
    io.save_sharded([{k: tensors[k] for k in keys[:9]}, {k: tensors[k] for k in keys[9:]}],
                    path)
    return sd


@pytest.fixture(scope="module")
def llama_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("llama"))
    _write_tiny_llama_dir(path)
    return path


def test_llama_from_pretrained_matches_reference_greedy(llama_dir):
    # The reference's from_pretrained('llama', dir) (int8, bf16 params) and
    # make_llama_chat_fn against the port's on the CPU. Both compute in bf16
    # (the reference's default dtype) with the same int8 weights: the tokens
    # must agree, and the first step's logits within 3e-2 (bf16 rounding of
    # the residual stream through two layers, logits of O(0.1-1)).
    from spider_tpu.models import factory as jfactory
    from spider_tpu.serving.spider_free import make_llama_chat_fn as jchat
    from spider_tpu_torch.serving.spider_free import make_llama_chat_fn as tchat

    jmodel, jparams, jtokz = jfactory.from_pretrained("llama", llama_dir)
    tmodel, ttokz = factory.from_pretrained("llama", path=llama_dir, device="cpu")
    assert tmodel.config.quantization == "int8" and tmodel.config.param_dtype == torch.bfloat16
    assert tmodel.device.type == "cpu"
    prompt = "Describe a horse running on a beach."
    want = jchat(jmodel, jparams, jtokz, max_new_tokens=12)(prompt)
    got = tchat(tmodel, ttokz, max_new_tokens=12)(prompt)
    assert got == want

    ids = np.asarray([ttokz(prompt, add_special_tokens=True).input_ids], np.int32)
    jlogits = np.asarray(jmodel.apply(jparams, jnp.asarray(ids))[0], np.float32)
    with torch.no_grad():
        tlogits = tmodel(torch.from_numpy(ids).long())[0].float().numpy()
    np.testing.assert_allclose(tlogits, jlogits, atol=3e-2, rtol=0)
    assert (tlogits.argmax(-1) == jlogits.argmax(-1)).mean() >= 0.9


def test_convert_llama_checkpoint_streams_each_tensor_once(llama_dir, monkeypatch):
    read, alive, peak = [], [], [0]
    real = io.SafetensorsFile.get

    def get(self, key):
        t = real(self, key)
        read.append(key)
        alive.append(weakref.ref(t))
        peak[0] = max(peak[0], sum(r() is not None for r in alive))
        return t

    monkeypatch.setattr(io.SafetensorsFile, "get", get)
    cfg, model = TC.convert_llama_checkpoint(llama_dir, device="cpu")
    assert (cfg.vocab_size, cfg.num_hidden_layers, cfg.param_dtype) == (300, 2, torch.float32)
    assert sorted(read) == sorted(io.open_state_dict(llama_dir))    # each key read once
    assert peak[0] == 1                     # and dropped before the next is read
    sd = TC.load_torch_state_dict(llama_dir)
    want = tL.LlamaForCausalLM(cfg, "cpu")
    want.load_state_dict(TC.convert_llama_state_dict(sd, cfg), strict=True)
    _assert_same_state(model, want)


def test_load_or_init_llm(llama_dir, tmp_path, monkeypatch):
    import shutil

    from spider_tpu_torch.models import serving_utils

    seen = []
    monkeypatch.setattr(factory, "load_tokenizer", lambda p: seen.append(p) or "hf-tokenizer")
    # A directory without tokenizer files is never handed to transformers,
    # which builds an empty tokenizer from one (ROADMAP C9): TinyTokenizer.
    model, tok = serving_utils.load_or_init_llm(llama_dir, device="cpu")
    assert isinstance(tok, ttok.TinyTokenizer) and seen == []
    with_files = str(tmp_path / "with_tokenizer")
    shutil.copytree(llama_dir, with_files)
    with open(os.path.join(with_files, "tokenizer.json"), "w") as f:
        f.write("{}")
    _, tok = serving_utils.load_or_init_llm(with_files, device="cpu")
    assert tok == "hf-tokenizer" and seen == [os.path.join(with_files, "")]
    assert model.config.quantization is None and model.config.param_dtype == torch.float32
    _, ref = TC.convert_llama_checkpoint(llama_dir, device="cpu")
    _assert_same_state(model, ref)
    tiny, tok = serving_utils.load_or_init_llm(device="cpu")
    assert isinstance(tok, ttok.TinyTokenizer) and tiny.config.num_hidden_layers == 2
    with pytest.raises(FileNotFoundError):
        serving_utils.load_or_init_llm(os.path.join(llama_dir, "absent"), device="cpu")


@pytest.mark.parametrize("extra", [dict(model_type="qwen2"), dict(attention_bias=True),
                                   dict(tie_word_embeddings=True)])
def test_unsupported_llama_configs_raise(tmp_path, extra):
    # Qwen2 biases and tied embeddings are read now (tests/test_torch_llama_family.py
    # loads such directories); what still raises: an int4 load of a checkpoint,
    # and a config asking for q/k/v biases that its checkpoint lacks (this
    # directory holds the plain Llama keys).
    _write_tiny_llama_dir(str(tmp_path), extra=extra)
    cfg = TC.read_llama_config(str(tmp_path))
    biased = "tie_word_embeddings" not in extra
    assert (cfg.attention_bias, cfg.tie_word_embeddings) == (biased, not biased)
    if biased:
        with pytest.raises(KeyError, match="q_proj.bias"):
            factory.from_pretrained("llama", path=str(tmp_path), device="cpu")
    else:
        model, _ = factory.from_pretrained("llama", path=str(tmp_path), device="cpu")
        assert not hasattr(model, "lm_head")
    with pytest.raises(NotImplementedError):
        factory.from_pretrained("llama", path=str(tmp_path), device="cpu",
                                quantization="int4")


def test_llama_config_reads_rope_scaling_as_reference(tmp_path):
    scaling = dict(factor=8.0, low_freq_factor=1.0, high_freq_factor=4.0,
                   original_max_position_embeddings=8192, rope_type="llama3")
    _write_tiny_llama_dir(str(tmp_path), extra=dict(rope_scaling=scaling, rope_theta=500000.0))
    cfg = TC.read_llama_config(str(tmp_path))
    jcfg, _ = JC.convert_llama_checkpoint(str(tmp_path))
    for f in ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
              "num_attention_heads", "num_key_value_heads", "max_position_embeddings",
              "rms_norm_eps", "rope_theta", "rope_scaling"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert "rope_type" not in cfg.rope_scaling


def test_load_tokenizer_copy_and_the_factory_fallback(monkeypatch, tmp_path):
    import sys
    import types

    class Tok:
        pad_token, eos_token, padding_side = None, "</s>", "left"

    fake = types.ModuleType("transformers")
    fake.AutoTokenizer = types.SimpleNamespace(from_pretrained=lambda p, use_fast: Tok())
    monkeypatch.setitem(sys.modules, "transformers", fake)
    for load in (jtok.load_tokenizer, ttok.load_tokenizer):
        tok = load("/some/dir")
        assert (tok.pad_token, tok.padding_side) == ("</s>", "right")
    assert type(ttok.load_tokenizer(None)).__name__ == type(jtok.load_tokenizer(None)).__name__
    # The factory hands transformers only a local directory with tokenizer
    # files; anything else, or a load that fails, gives TinyTokenizer.
    (tmp_path / "tokenizer").mkdir()
    assert isinstance(factory._hf_tokenizer(str(tmp_path)), ttok.TinyTokenizer)
    (tmp_path / "tokenizer" / "tokenizer_config.json").write_text("{}")
    assert isinstance(factory._hf_tokenizer(str(tmp_path)), Tok)
    assert isinstance(factory._hf_tokenizer(str(tmp_path / "weights.pth")), ttok.TinyTokenizer)
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        ttok.load_tokenizer("/some/dir")
    assert isinstance(factory._hf_tokenizer(str(tmp_path)), ttok.TinyTokenizer)


# ---- diffusers directories and the trainable Spider ------------------------

@pytest.fixture
def tiny_presets(monkeypatch):
    """The full presets that from_pretrained and build_full_spider build,
    replaced by the tiny ones (cross-attention and projection widths as
    pipelines/ad.py and the emitters have them)."""
    monkeypatch.setattr(tclip, "clip_vit_l14", lambda: tclip.clip_tiny(100))
    monkeypatch.setattr(tclip, "clip_vit_h14", lambda: tclip.clip_tiny(100))
    monkeypatch.setattr(tclip, "open_clip_bigg", lambda: dataclasses.replace(
        tclip.clip_tiny(100), hidden_size=48, intermediate_size=96, projection_dim=48,
        hidden_act="gelu"))
    monkeypatch.setattr(tunet, "unet_sdxl", lambda: tunet.unet_tiny(**TINY_SDXL_UNET))
    monkeypatch.setattr(tvae, "vae_sdxl", lambda: tvae.vae_tiny())
    clap, full = tclip.clap_tiny(300), tclip.ClapTextConfig
    monkeypatch.setattr(tclip, "ClapTextConfig", lambda **kw: full(**kw) if kw else clap)
    monkeypatch.setattr(tunet, "unet_sd15", lambda: tunet.unet_tiny())
    monkeypatch.setattr(tunet, "unet_audioldm", lambda: tunet.unet_tiny())
    monkeypatch.setattr(tunet3d, "unet3d_zeroscope", lambda: tunet3d.unet3d_tiny())
    monkeypatch.setattr(tvae, "vae_sd", lambda: tvae.vae_tiny())
    monkeypatch.setattr(tvae, "vae_audioldm", lambda: tvae.vae_tiny())
    monkeypatch.setattr(tvoc, "hifigan_audioldm", lambda: tvoc.hifigan_tiny())
    monkeypatch.setattr(tib, "imagebind_huge", lambda: tib.imagebind_tiny())


def _write(sd, path, name="diffusion_pytorch_model.safetensors"):
    os.makedirs(path, exist_ok=True)
    tensors = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    if name.endswith(".safetensors"):
        io.save_file(tensors, os.path.join(path, name))
    else:
        torch.save(tensors, os.path.join(path, name))


@pytest.mark.parametrize("kind", ["sd15", "zeroscope", "audioldm", "sdxl_story"])
def test_pipeline_from_diffusers_directory(tmp_path, tiny_presets, kind):
    root = str(tmp_path)
    cases = {"sd15": ("clip", "unet_sd", "vae"), "zeroscope": ("clip", "unet3d", "vae"),
             "audioldm": ("clap", "unet_audioldm", "vae", "hifigan_weight_norm"),
             "sdxl_story": ("clip", "clip_bigg", "unet_sdxl", "vae")}[kind]
    subs = (("text_encoder", "text_encoder_2", "unet", "vae") if kind == "sdxl_story"
            else ("text_encoder", "unet", "vae", "vocoder"))
    wants = {}
    for sub, case in zip(subs, cases):
        sd, ref_tree, _, make = _family_case(case)
        _write(sd, os.path.join(root, sub),
               "pytorch_model.bin" if sub == "vocoder" else "diffusion_pytorch_model.safetensors")
        wants[sub] = load_jax_params(make(), _np_tree(ref_tree))

    pipe = factory.from_pretrained(kind, path=root, device="cpu", dtype=torch.float32)
    got = {"text_encoder": pipe.text_encoder, "unet": pipe.unet, "vae": pipe.vae}
    if kind == "audioldm":
        got["vocoder"] = pipe.vocoder
    if kind == "sdxl_story":
        got["text_encoder_2"] = pipe.text_encoder_2
        assert isinstance(pipe.tokenizer_2, ttok.TinyTokenizer)
        assert (pipe.height, pipe.width, pipe.batched_cfg) == (768, 768, True)
    assert sorted(got) == sorted(wants)
    for sub in got:
        _assert_same_state(got[sub], wants[sub])
    assert isinstance(pipe.tokenizer, ttok.TinyTokenizer)


def test_imagebind_from_pth_file(tmp_path, tiny_presets):
    sd, ref_tree, _, make = _family_case("imagebind")
    _write(sd, str(tmp_path), "imagebind_huge.pth")
    got = factory.from_pretrained("imagebind", path=str(tmp_path / "imagebind_huge.pth"),
                                  device="cpu", dtype=torch.float32)
    _assert_same_state(got, load_jax_params(make(), _np_tree(ref_tree)))


def test_build_full_spider_from_paths(tmp_path, tiny_presets, monkeypatch):
    llama = str(tmp_path / "llama")
    sd = _write_tiny_llama_dir(llama)
    ib, ib_tree, _, ib_make = _family_case("imagebind")
    _write(ib, str(tmp_path / "ib"), "imagebind_huge.pth")
    monkeypatch.setattr(factory, "_llama_proj",
                        lambda e, h, d, g: torch.nn.Linear(tib.imagebind_tiny().embed_dim, h))
    spider = factory.build_spider_from_config(
        dict(preset="full", paths=dict(llama=llama, imagebind=str(tmp_path / "ib"), sam=""),
             lora_r=4, with_pipes=False, use_moe_aligner=False, max_context_len=64),
        device="cpu")
    llm = spider.llm
    V = 300
    new_vocab = llm.config.vocab_size
    assert new_vocab == -(-(V + len(spider.tokenizer)) // 128) * 128 and new_vocab > V
    # base leaves: the checkpoint's, stored in bf16; rows past V: the
    # reference's extension rows, in fp32
    base = TC.convert_llama_state_dict(sd, dataclasses.replace(llm.config, vocab_size=V))
    state = llm.state_dict()
    for name, t in base.items():
        if name in ("embed_tokens.weight", "lm_head.weight"):
            assert torch.equal(state[name][:V], t.float()), name
        else:
            assert state[name].dtype == torch.bfloat16
            assert torch.equal(state[name], t.to(torch.bfloat16)), name
    jcfg = jL.llama_tiny(vocab_size=V)
    ext = JC.extend_llama_embeddings(JC.convert_llama_state_dict(sd, jcfg), new_vocab)["params"]
    np.testing.assert_array_equal(state["embed_tokens.weight"][V:].numpy(),
                                  np.asarray(ext["embed_tokens"]["embedding"])[V:])
    np.testing.assert_array_equal(state["lm_head.weight"][V:].numpy(),
                                  np.asarray(ext["lm_head"]["kernel"]).T[V:])
    # trainable: the LoRA pairs and the fp32 vocabulary matrices; the base frozen
    trainable = {n for n, p in llm.named_parameters() if p.requires_grad}
    assert trainable == {n for n in state if n.endswith(("lora_a", "lora_b"))} | {
        "embed_tokens.weight", "lm_head.weight"}
    assert llm.embed_tokens.weight.dtype == torch.float32
    assert not torch.count_nonzero(llm.model.layers[0].self_attn.q_proj.lora_b)
    _assert_same_state(spider.encoder, load_jax_params(ib_make(), _np_tree(ib_tree)),
                       cast=True)
    with pytest.raises(ValueError, match="with_sam"):      # a SAM path needs with_sam
        factory.build_full_spider(device="cpu", paths=dict(llama=llama, sam="/x"))
    with pytest.raises(ValueError, match="no checkpoint paths"):
        factory.build_spider_from_config(dict(preset="tiny", paths=dict(llama=llama)),
                                         device="cpu")


def test_train_entry_reaches_the_checkpoint(tmp_path, tiny_presets, monkeypatch):
    # `python -m spider_tpu_torch.train train_configs/spider_demo_train_full.py
    # --options model.paths.llama=<dir>`: the parser's override reaches
    # build_full_spider, whose llm then holds the checkpoint's weights.
    from spider_tpu_torch import train as T
    from spider_tpu_torch.common.config import Config, apply_overrides
    from spider_tpu_torch.tasks.base_task import BaseTask

    llama = str(tmp_path / "llama")
    sd = _write_tiny_llama_dir(llama)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg_path = os.path.join(root, "train_configs", "spider_demo_train_full.py")
    args = T.parse_args([cfg_path, "--device", "cpu", "--options", f"model.paths.llama={llama}",
                         "model.with_encoder=False"])
    cfg = apply_overrides(Config.fromfile(args.cfg_path), args.options)
    assert cfg.model["paths"]["llama"] == llama
    monkeypatch.setattr(factory, "_llama_proj", lambda e, h, d, g: torch.nn.Linear(e, h))
    T.register_all()
    spider = BaseTask().build_model(cfg, device="cpu")
    got = spider.llm.model.layers[1].mlp.down_proj.weight
    want = torch.from_numpy(sd["model.layers.1.mlp.down_proj.weight"]).to(got.dtype)
    assert torch.equal(got, want)
    assert spider.llm.config.lora.r == 32 and spider.max_context_len == 100
