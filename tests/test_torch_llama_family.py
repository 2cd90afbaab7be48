"""The rest of the Llama family in the port against the JAX package: q/k/v
biases (Qwen2), tied embeddings, ``call_with_final``, multimodal RoPE, the
presets, the cache dtype, and Qwen2-layout and tied HF directories through
``read_llama_config`` / ``llama_rules`` / ``from_pretrained``.

Weights are made with numpy in the shape of the JAX module's init tree and
reach the port through ``load_jax_params``; inputs come from numpy seeds.
fp32 on the CPU at llama_tiny width. Tolerances: 1e-5 on a single dense
layer and on RoPE (the same fp32 products, summed in another order); 1e-4 on
logits and hidden states after two layers (as tests/test_torch_llama.py);
checkpoint conversions are bit-equal.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spider_tpu.models import convert as JC
from spider_tpu.models import llama as jL
from spider_tpu.ops import rope as jrope
from spider_tpu_torch.models import checkpoint_io as io
from spider_tpu_torch.models import convert as TC
from spider_tpu_torch.models import factory
from spider_tpu_torch.models import llama as tL
from spider_tpu_torch.models.convert import load_jax_params
from spider_tpu_torch.ops import rope as trope
from test_convert import _fake_llama_sd
from test_torch_llama import _params


def _pair(seed=0, quant=None, **fields):
    """(jax model, jax params, port model) of llama_tiny with `fields`."""
    jcfg = dataclasses.replace(jL.llama_tiny(vocab_size=256), quantization=quant, **fields)
    jm = jL.LlamaForCausalLM(jcfg)
    params = _params(jm, seed)
    tcfg = dataclasses.replace(tL.llama_tiny(vocab_size=256), quantization=quant, **fields)
    tm = tL.LlamaForCausalLM(tcfg)
    load_jax_params(tm, params)
    return jm, params, tm.eval()


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_lora_dense_with_bias_matches_jax(quant):
    # The bias is added in dtype after the quantisation scale (1e-5).
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    jd = jL.LoraDense(48, use_bias=True, dtype=jnp.float32, quantization=quant)
    shapes = jax.eval_shape(jd.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    p = {}
    for name, s in shapes.items():
        if s.dtype == jnp.int8:
            p[name] = rng.integers(-128 if quant == "int4" else -127, 128,
                                   size=s.shape).astype(np.int8)
        elif name == "kernel_scale":
            p[name] = np.full(s.shape, 3e-3, np.float32)
        else:
            p[name] = (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
    want = np.asarray(jd.apply({"params": p}, jnp.asarray(x)))
    td = tL.LoraDense(32, 48, torch.float32, torch.float32, quant, use_bias=True)
    load_jax_params(td, {"params": p})
    assert td.bias is not None and td.bias.abs().max() > 0
    with torch.no_grad():
        got = td(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_attention_bias_prefill_and_decode_match_jax(quant):
    # Qwen2's q/k/v biases; o and the MLP have none, as in the JAX tree.
    jm, params, tm = _pair(seed=5, quant=quant, attention_bias=True)
    attn = tm.model.layers[0].self_attn
    assert all(getattr(attn, n).bias is not None for n in ("q_proj", "k_proj", "v_proj"))
    assert attn.o_proj.bias is None and tm.model.layers[0].mlp.down_proj.bias is None
    rng = np.random.default_rng(6)
    ids = rng.integers(3, 256, size=(2, 9)).astype(np.int32)
    plen = np.array([9, 6], np.int32)
    jc = jL.init_kv_cache(jm.config, 2, 16)
    tc = tL.init_kv_cache(tm.config, 2, 16)
    jl, _, jc = jm.apply(params, jnp.asarray(ids), kv_write_index=0, kv_cache=jc,
                         kv_len=jnp.asarray(plen))
    step = rng.integers(3, 256, size=(2, 1)).astype(np.int32)
    jl2, _, _ = jm.apply(params, jnp.asarray(step), positions=jnp.asarray(plen)[:, None],
                         kv_write_index=jnp.asarray(plen), kv_cache=jc,
                         kv_len=jnp.asarray(plen + 1))
    with torch.no_grad():
        tl, _, tc = tm(input_ids=torch.from_numpy(ids).long(), kv_write_index=0, kv_cache=tc,
                       kv_len=torch.from_numpy(plen))
        p = torch.from_numpy(plen)
        tl2, _, _ = tm(input_ids=torch.from_numpy(step).long(), positions=p[:, None],
                       kv_write_index=p, kv_cache=tc, kv_len=p + 1)
    for i, n in enumerate(plen):        # live rows of the right-padded prefill
        np.testing.assert_allclose(tl[i, :n].numpy(), np.asarray(jl)[i, :n], atol=1e-4, rtol=0)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=1e-4, rtol=0)


def test_tied_logits_and_call_with_final_match_jax():
    jm, params, tm = _pair(seed=7, tie_word_embeddings=True)
    assert "lm_head" not in params["params"] and not hasattr(tm, "lm_head")
    ids = np.random.default_rng(8).integers(3, 256, size=(2, 7)).astype(np.int32)
    emb = jm.apply(params, jnp.asarray(ids), method=jm.embed)
    jl, jfinal, _ = jm.apply(params, emb, method=jm.call_with_final)
    _, jh, _ = jm.apply(params, jnp.asarray(ids), output_hidden_states=True)
    with torch.no_grad():
        temb = tm.embed(torch.from_numpy(ids).long())
        tl, tfinal, cache = tm.call_with_final(temb)
        full, th, _ = tm(input_ids=torch.from_numpy(ids).long(), output_hidden_states=True)
    assert cache is None
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tfinal.numpy(), np.asarray(jfinal), atol=1e-4, rtol=0)
    # final is the last hidden state, and the forward's logits are the same
    assert torch.equal(tfinal, th[-1]) and torch.equal(tl, full)
    np.testing.assert_allclose(th[-1].numpy(), np.asarray(jh)[-1], atol=1e-4, rtol=0)


def test_call_with_final_with_a_cache_matches_jax():
    jm, params, tm = _pair(seed=9)
    ids = np.random.default_rng(10).integers(3, 256, size=(1, 6)).astype(np.int32)
    emb = jm.apply(params, jnp.asarray(ids), method=jm.embed)
    jl, jfinal, _ = jm.apply(params, emb, kv_cache=jL.init_kv_cache(jm.config, 1, 12),
                             kv_len=jnp.asarray([6], jnp.int32), method=jm.call_with_final)
    with torch.no_grad():
        tl, tfinal, cache = tm.call_with_final(
            tm.embed(torch.from_numpy(ids).long()),
            kv_cache=tL.init_kv_cache(tm.config, 1, 12), kv_len=torch.tensor([6]))
    assert cache[0].shape == (2, 1, 12, 2, 16) and cache[0][:, :, :6].abs().sum() > 0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tfinal.numpy(), np.asarray(jfinal), atol=1e-4, rtol=0)


@pytest.mark.parametrize("section", [(2, 3, 3), (16, 24, 24)])
def test_apply_mrope_matches_jax(section):
    D = 2 * sum(section)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 5, 3, D)).astype(np.float32)
    pos = rng.integers(0, 300, size=(3, 2, 5)).astype(np.int32)
    inv = np.asarray(jrope.rope_inv_freq(D, 1e6))
    want = np.asarray(jrope.apply_mrope(jnp.asarray(x), jnp.asarray(pos), jnp.asarray(inv),
                                        section))
    inv = inv.copy()
    got = trope.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), torch.from_numpy(inv),
                            section).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # text positions (t = h = w) are plain RoPE, bit for bit
    same = torch.from_numpy(np.broadcast_to(pos[:1], pos.shape).copy())
    assert torch.equal(trope.apply_mrope(torch.from_numpy(x), same, torch.from_numpy(inv), section),
                       trope.apply_rope(torch.from_numpy(x), same[0], torch.from_numpy(inv)))
    with pytest.raises(ValueError):
        trope.apply_mrope(torch.from_numpy(x), same, torch.from_numpy(inv), (1, 1, 1))


def test_mrope_forward_matches_jax():
    # Qwen2-VL positions [3, B, T] take the mrope branch; [B, T] the plain one.
    jm, params, tm = _pair(seed=12, attention_bias=True, mrope_section=(2, 3, 3))
    rng = np.random.default_rng(13)
    ids = rng.integers(3, 256, size=(2, 8)).astype(np.int32)
    pos = np.sort(rng.integers(0, 40, size=(3, 2, 8)), axis=-1).astype(np.int32)
    jl, _, _ = jm.apply(params, jnp.asarray(ids), positions=jnp.asarray(pos))
    with torch.no_grad():
        tl, _, _ = tm(input_ids=torch.from_numpy(ids).long(), positions=torch.from_numpy(pos))
        plain, _, _ = tm(input_ids=torch.from_numpy(ids).long())
        text3 = torch.arange(8, dtype=torch.int32)[None, None].expand(3, 2, 8)
        text, _, _ = tm(input_ids=torch.from_numpy(ids).long(), positions=text3)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    assert not torch.allclose(tl, plain)
    assert torch.equal(text, plain)


@pytest.mark.parametrize("preset", ["llama2_7b", "llama3_8b", "qwen2_7b"])
def test_presets_match_jax(preset):
    j, t = getattr(jL, preset)(), getattr(tL, preset)()
    for f in dataclasses.fields(t):
        if f.name in ("dtype", "param_dtype", "lora"):
            continue
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.lora.r == j.lora.r and t.head_dim_ == j.head_dim_
    assert (t.dtype, t.param_dtype) == (torch.bfloat16, torch.float32)


def test_init_kv_cache_dtype():
    cfg = tL.llama_tiny()
    k, v = tL.init_kv_cache(cfg, 2, 8)
    assert k.dtype == v.dtype == torch.float32 and k.shape == (2, 2, 8, 2, 16)
    k, _ = tL.init_kv_cache(cfg, 2, 8, dtype=torch.bfloat16)
    assert k.dtype == torch.bfloat16 and not k.any()


# ---- HF directories in the Qwen2 layout and with tied embeddings ----------

def _write_dir(path, kind):
    """A tiny HF directory: 'qwen2' (model_type qwen2, q/k/v biases, no
    attention_bias key, as Qwen2's config.json has it) or 'tied' (a Llama
    config with tie_word_embeddings and no lm_head.weight)."""
    jcfg = dataclasses.replace(jL.llama_tiny(vocab_size=300),
                               attention_bias=kind == "qwen2",
                               tie_word_embeddings=kind == "tied")
    rng = np.random.default_rng(21)
    sd = _fake_llama_sd(jcfg, rng)
    if kind == "qwen2":
        kv = jcfg.num_key_value_heads * jcfg.head_dim_
        for i in range(jcfg.num_hidden_layers):
            b = f"model.layers.{i}.self_attn."
            for n, w in (("q_proj", jcfg.hidden_size), ("k_proj", kv), ("v_proj", kv)):
                sd[b + n + ".bias"] = rng.normal(0, 0.05, (w,)).astype(np.float32)
    else:
        del sd["lm_head.weight"]
    hf = dict(model_type=kind if kind == "qwen2" else "llama", vocab_size=300,
              hidden_size=64, intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=512,
              rms_norm_eps=1e-6, rope_theta=1e6, tie_word_embeddings=kind == "tied",
              torch_dtype="float32")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f)
    keys = sorted(sd)
    tensors = {k: torch.from_numpy(sd[k]) for k in keys}
    io.save_sharded([{k: tensors[k] for k in keys[:10]}, {k: tensors[k] for k in keys[10:]}],
                    path)
    return sd


@pytest.fixture(scope="module", params=["qwen2", "tied"])
def hf_dir(request, tmp_path_factory):
    path = str(tmp_path_factory.mktemp(request.param))
    _write_dir(path, request.param)
    return request.param, path


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_checkpoint_loads_bit_equal_to_the_reference(hf_dir, quantize):
    # read_llama_config + llama_rules against the reference's
    # convert_llama_checkpoint + load_jax_params: every tensor bit-equal.
    kind, path = hf_dir
    cfg = TC.read_llama_config(path, quantize)
    jcfg, jparams = JC.convert_llama_checkpoint(path, quantize)
    assert (cfg.attention_bias, cfg.tie_word_embeddings) == (kind == "qwen2", kind == "tied")
    assert (jcfg.attention_bias, jcfg.tie_word_embeddings) == (cfg.attention_bias,
                                                              cfg.tie_word_embeddings)
    _, model = TC.convert_llama_checkpoint(path, quantize, device="cpu")
    want = load_jax_params(tL.LlamaForCausalLM(cfg), jparams)
    sa, sb = model.state_dict(), want.state_dict()
    assert sorted(sa) == sorted(sb)
    assert any(k.endswith("q_proj.bias") for k in sa) == (kind == "qwen2")
    assert ("lm_head.weight" in sa or "lm_head.kernel_q" in sa) == (kind != "tied")
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k
    if quantize is None:                # and the loaded model computes as the reference
        ids = np.random.default_rng(22).integers(3, 300, size=(1, 9)).astype(np.int32)
        jm = jL.LlamaForCausalLM(dataclasses.replace(jcfg, dtype=jnp.float32))
        jl = np.asarray(jm.apply(jparams, jnp.asarray(ids))[0])
        fp32 = tL.LlamaForCausalLM(dataclasses.replace(cfg, dtype=torch.float32)).eval()
        fp32.load_state_dict(sa, strict=True)
        with torch.no_grad():
            tl = fp32(input_ids=torch.from_numpy(ids).long())[0].numpy()
        np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)


def test_from_pretrained_loads_the_qwen2_and_tied_layouts(hf_dir):
    # The serving entry: int8 projections and bf16 embeddings, as for a Llama.
    kind, path = hf_dir
    model, _ = factory.from_pretrained("llama", path=path, device="cpu")
    cfg = model.config
    assert (cfg.quantization, cfg.param_dtype) == ("int8", torch.bfloat16)
    assert cfg.attention_bias == (kind == "qwen2") and cfg.tie_word_embeddings == (kind == "tied")
    sd = io.open_state_dict(path)
    with sd:
        if kind == "qwen2":
            b = model.model.layers[1].self_attn.k_proj.bias
            assert torch.equal(b, sd["model.layers.1.self_attn.k_proj.bias"].to(b.dtype))
        else:
            assert not hasattr(model, "lm_head")
            w = sd["model.embed_tokens.weight"].to(torch.bfloat16)
            h = torch.randn(1, 3, 64, dtype=torch.bfloat16)
            assert torch.equal(model.logits(h), h @ w.T)
    with torch.no_grad():
        logits = model(input_ids=torch.tensor([[5, 6, 7]]))[0]
    assert logits.shape == (1, 3, 300) and torch.isfinite(logits).all()
