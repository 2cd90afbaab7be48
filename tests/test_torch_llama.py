"""Parity of the port's Llama decoder and generate loop with the JAX package.

Weights are made with numpy in the shape of the JAX module's init tree and
reach the port through load_jax_params; token ids are made with numpy from a
seed. Everything runs
in fp32 on the CPU at llama_tiny width. Tolerance 1e-4 on logits and hidden
states: the same fp32 arithmetic accumulated in another order over two
layers; generated tokens must be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spider_tpu.models import decode as jdecode
from spider_tpu.models import llama as jL
from spider_tpu_torch.models import decode as tdecode
from spider_tpu_torch.models import llama as tL
from spider_tpu_torch.models.convert import load_jax_params


def _params(jm, seed):
    """Random weights in the shape of the JAX model's parameter tree, from
    numpy: floats ~ N(0, 0.05), norm scales 1 + N(0, 0.05), int8 kernels
    uniform in [-127, 127] with scale 2e-3 (activations of the random model
    stay O(1), so 1e-4 is a tight bound)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))

    def fill(path, s):
        key = jax.tree_util.keystr(path)
        if s.dtype == jnp.int8:
            return rng.integers(-127, 128, size=s.shape).astype(np.int8)
        if "kernel_scale" in key:
            return np.full(s.shape, 2e-3, np.float32)
        x = 0.05 * rng.standard_normal(s.shape, dtype=np.float32)
        return x + 1.0 if "layernorm" in key or key.endswith("['norm']") else x

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _pair(quant=None, vocab=512, seed=0, lora_r=0, remat=False):
    """(jax model, jax params, port model) with the same weights."""
    jm = jL.LlamaForCausalLM(dataclasses.replace(
        jL.llama_tiny(vocab_size=vocab, lora_r=lora_r), quantization=quant))
    params = _params(jm, seed)
    tm = tL.LlamaForCausalLM(dataclasses.replace(
        tL.llama_tiny(vocab_size=vocab, lora_r=lora_r), quantization=quant, remat=remat))
    load_jax_params(tm, params)
    return jm, params, tm.eval()


@pytest.mark.parametrize("quant", [None, "int8"])
def test_logits_and_hidden_states_match_jax(quant):
    jm, params, tm = _pair(quant)
    ids = np.random.default_rng(1).integers(3, 512, size=(2, 11)).astype(np.int32)
    jl, jh, _ = jax.jit(jm.apply, static_argnames="output_hidden_states")(
        params, jnp.asarray(ids), output_hidden_states=True)
    with torch.no_grad():
        tl, th, _ = tm(input_ids=torch.from_numpy(ids).long(), output_hidden_states=True)
    assert th.shape == jh.shape == (3, 2, 11, 64)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4, rtol=0)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_cached_prefill_and_decode_step_match_jax(quant):
    # Right-padded batch prefill into a cache, then one step with per-sample
    # write indices: the flash path (T > 1) and the decode path (T == 1).
    jm, params, tm = _pair(quant, seed=3)
    rng = np.random.default_rng(4)
    ids = rng.integers(3, 512, size=(2, 9)).astype(np.int32)
    plen = np.array([9, 6], np.int32)
    jc = jL.init_kv_cache(jm.config, 2, 16)
    tc = tL.init_kv_cache(tm.config, 2, 16)
    jl, _, jc = jm.apply(params, jnp.asarray(ids), kv_write_index=0, kv_cache=jc,
                         kv_len=jnp.asarray(plen))
    nxt = rng.integers(3, 512, size=(2, 1)).astype(np.int32)
    jl2, _, jc = jm.apply(params, jnp.asarray(nxt), positions=jnp.asarray(plen)[:, None],
                          kv_write_index=jnp.asarray(plen), kv_cache=jc,
                          kv_len=jnp.asarray(plen + 1))
    with torch.no_grad():
        tl, _, tc = tm(input_ids=torch.from_numpy(ids).long(), kv_write_index=0,
                       kv_cache=tc, kv_len=torch.from_numpy(plen))
        tp = torch.from_numpy(plen)
        tl2, _, tc = tm(input_ids=torch.from_numpy(nxt).long(), positions=tp[:, None],
                        kv_write_index=tp, kv_cache=tc, kv_len=tp + 1)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=1e-4, rtol=0)
    for j, t in zip(jc, tc):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-4, rtol=0)


@pytest.mark.parametrize("with_eos", [False, True])
def test_generate_tokens_equal_jax(with_eos):
    jm, params, tm = _pair(seed=5)
    rng = np.random.default_rng(6)
    ids = rng.integers(3, 512, size=(2, 10)).astype(np.int32)
    plen = np.array([10, 7], np.int32)
    gcfg = dict(max_new_tokens=12, collect_layers=(-1, 1))
    emb = np.asarray(jm.apply(params, jnp.asarray(ids), method=jm.embed))
    jout = jdecode.generate(jm, params, jnp.asarray(emb), jnp.asarray(plen),
                            jdecode.GenerateConfig(**gcfg))
    if with_eos:
        # Stop sample 1 early on its own fifth token: exercises done/pad/kv_len.
        gcfg["eos_ids"] = (int(jout["tokens"][1, 4]),)
        jout = jdecode.generate(jm, params, jnp.asarray(emb), jnp.asarray(plen),
                                jdecode.GenerateConfig(**gcfg))
        assert bool(jout["done"][1])
    tout = tdecode.generate(tm, torch.tensor(emb), torch.from_numpy(plen),
                            tdecode.GenerateConfig(**gcfg))
    np.testing.assert_array_equal(tout["tokens"].numpy(), np.asarray(jout["tokens"]))
    np.testing.assert_array_equal(tout["done"].numpy(), np.asarray(jout["done"]))
    np.testing.assert_array_equal(tout["kv_len"].numpy(), np.asarray(jout["kv_len"]))
    assert tout["step_hidden"].shape == jout["step_hidden"].shape == (11, 2, 2, 64)
    np.testing.assert_allclose(tout["step_hidden"].numpy(), np.asarray(jout["step_hidden"]),
                               atol=1e-4, rtol=0)


def test_sampled_generate_draws_only_from_its_generator():
    # jax.random and torch.Generator draw different streams, so sampled
    # decoding is checked for determinism, not against the JAX tokens.
    _, _, tm = _pair(seed=7)
    emb = tm.embed(torch.from_numpy(np.arange(3, 11)[None]).long()).detach()
    plen = torch.tensor([8], dtype=torch.int32)
    gcfg = tdecode.GenerateConfig(max_new_tokens=10, temperature=1.0, top_p=0.9)
    run = lambda g: tdecode.generate(tm, emb, plen, gcfg, generator=g)["tokens"]
    torch.manual_seed(123)        # the global RNG must not matter
    a = run(torch.Generator().manual_seed(1))
    torch.manual_seed(456)
    torch.testing.assert_close(a, run(torch.Generator().manual_seed(1)))
    torch.testing.assert_close(run(None), run(torch.Generator().manual_seed(0)))


def test_load_jax_params_rejects_mismatched_trees():
    _, params, tm = _pair()
    bad = jax.tree_util.tree_map(lambda a: a, params)
    del bad["params"]["lm_head"]
    with pytest.raises(KeyError, match="lm_head"):
        load_jax_params(tm, bad)
    wrong = tL.LlamaForCausalLM(tL.llama_tiny(vocab_size=256))
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(wrong, params)


def test_lora_logits_match_jax_and_the_branch_is_live():
    # _params fills lora_b too (flax starts it at zero), so the branch counts.
    jm, params, tm = _pair(lora_r=4, seed=8)
    ids = np.random.default_rng(9).integers(3, 512, size=(2, 7)).astype(np.int32)
    jl, _, _ = jm.apply(params, jnp.asarray(ids))
    with torch.no_grad():
        tl, _, _ = tm(input_ids=torch.from_numpy(ids).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
        q_proj = tm.model.layers[0].self_attn.q_proj
        assert q_proj.lora_scale == 21.0 / 4 and q_proj.lora_a.shape == (64, 4)
        assert not hasattr(tm.model.layers[0].mlp.gate_proj, "lora_a")   # not a target
        q_proj.lora_b.zero_()
        assert (tm(input_ids=torch.from_numpy(ids).long())[0] - tl).abs().max() > 1e-4
    fresh = tL.LlamaForCausalLM(tL.llama_tiny(lora_r=4))
    assert not fresh.model.layers[0].self_attn.o_proj.lora_b.any()


def test_remat_gives_the_same_loss_and_gradients():
    _, params, plain = _pair(lora_r=4, seed=10)
    _, _, remat = _pair(lora_r=4, seed=10, remat=True)
    rng = np.random.default_rng(11)
    ids = torch.from_numpy(rng.integers(3, 512, size=(2, 9))).long()
    labels = ids.clone()
    labels[:, :4] = -100
    grads = []
    for m in (plain, remat):
        m.train()
        loss, _ = tL.cross_entropy_loss(m(input_ids=ids)[0], labels)
        loss.backward()
        grads.append((loss.item(), {n: p.grad.clone() for n, p in m.named_parameters()}))
    assert grads[0][0] == pytest.approx(grads[1][0], abs=1e-6)
    assert set(grads[0][1]) == set(grads[1][1])
    for n, g in grads[0][1].items():
        torch.testing.assert_close(grads[1][1][n], g, rtol=0, atol=1e-6, msg=n)


@pytest.mark.parametrize("labels_kind", ["answer_span", "all_ignored", "other_ignore_index"])
def test_cross_entropy_loss_matches_jax(labels_kind):
    rng = np.random.default_rng(12)
    logits = (3 * rng.standard_normal((2, 6, 19))).astype(np.float32)
    labels = rng.integers(0, 19, size=(2, 6))
    ignore = -100
    if labels_kind == "answer_span":
        labels[:, :3] = -100
    elif labels_kind == "all_ignored":
        labels[:] = -100
    else:
        ignore = 7
    jl, ja = jL.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels), ignore)
    tl, ta = tL.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels), ignore)
    assert float(tl) == pytest.approx(float(jl), abs=1e-5)
    assert float(ta) == pytest.approx(float(ja), abs=1e-6)
    if labels_kind == "all_ignored":
        assert float(tl) == 0.0 and float(ta) == 0.0
