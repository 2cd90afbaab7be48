"""Parity of the port's int4 weight-only quantization with the JAX package.

Inputs are made with numpy from a seed. The packing functions must give
equal bytes. ``int4_matmul`` on CPU tensors is the plain version, held to the
JAX ``int4_matmul_reference`` in fp32 at 1e-5 (the same exact products,
summed in another order; outputs are O(1)). The int4 ``llama_tiny`` goes
through ``load_jax_params`` and is held at 1e-4, as tests/test_torch_llama.py
holds the fp and int8 models.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spider_tpu.models import llama as jL
from spider_tpu.ops import quant as jQ
from spider_tpu_torch.models import factory
from spider_tpu_torch.models import llama as tL
from spider_tpu_torch.models.convert import load_jax_params
from spider_tpu_torch.ops import quant as tQ

# Spread of a nibble of a uniformly drawn byte (uniform in [-8, 7]).
INT4_STD = ((16 ** 2 - 1) / 12) ** 0.5


def test_pack_unpack_quantize_bytes_equal_jax():
    rng = np.random.default_rng(0)
    w = rng.integers(-8, 8, size=(64, 24)).astype(np.int8)
    packed = tQ.pack_int4(torch.from_numpy(w))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jQ.pack_int4(jnp.asarray(w))))
    assert packed.dtype == torch.int8 and packed.shape == (32, 24)
    raw = rng.integers(-128, 128, size=(16, 8)).astype(np.int8)
    np.testing.assert_array_equal(
        tQ.unpack_int4(torch.from_numpy(raw), torch.int32).numpy(),
        np.asarray(jQ.unpack_int4(jnp.asarray(raw), jnp.int32)))
    wf = (0.05 * rng.standard_normal((128, 40))).astype(np.float32)
    tp, ts = tQ.quantize_int4(torch.from_numpy(wf))
    jp, js = jQ.quantize_int4(jnp.asarray(wf))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_pack_rejects_odd_rows():
    with pytest.raises(ValueError):
        tQ.pack_int4(torch.zeros(5, 3, dtype=torch.int8))


@pytest.mark.parametrize("M", [1, 16, 1100])
def test_int4_matmul_equals_jax_reference(M):
    # M = 1100 is past the kernel's 1024 rows; on CPU tensors every M takes
    # the plain version.
    rng = np.random.default_rng(M)
    K, N = 96, 40
    x = rng.standard_normal((M, K), dtype=np.float32)
    packed = rng.integers(-128, 128, size=(K // 2, N)).astype(np.int8)   # JAX [K/2, N]
    scale = (rng.uniform(0.5, 1.5, N) / (INT4_STD * K ** 0.5)).astype(np.float32)
    want = np.asarray(jQ.int4_matmul_reference(jnp.asarray(x), jnp.asarray(packed),
                                               jnp.asarray(scale)))
    got = tQ.int4_matmul(torch.from_numpy(x), torch.from_numpy(packed.T.copy()),
                         torch.from_numpy(scale))
    assert got.shape == (M, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def _params(jm, seed):
    """Random weights in the shape of the JAX int4 model's tree, from numpy:
    floats ~ N(0, 0.05), norm scales 1 + N(0, 0.05), packed bytes uniform
    (nibbles uniform in [-8, 7]) with scale 0.03, so activations stay O(1)
    and 1e-4 is a tight bound."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))

    def fill(path, s):
        key = jax.tree_util.keystr(path)
        if s.dtype == jnp.int8:
            return rng.integers(-128, 128, size=s.shape).astype(np.int8)
        if "kernel_scale" in key:
            return np.full(s.shape, 0.03, np.float32)
        x = 0.05 * rng.standard_normal(s.shape, dtype=np.float32)
        return x + 1.0 if "layernorm" in key or key.endswith("['norm']") else x

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _int4_pair(seed):
    jm = jL.LlamaForCausalLM(dataclasses.replace(jL.llama_tiny(), quantization="int4",
                                                 dtype=jnp.float32))
    params = _params(jm, seed)
    tm = tL.LlamaForCausalLM(dataclasses.replace(tL.llama_tiny(), quantization="int4"))
    load_jax_params(tm, params)
    return jm, params, tm.eval()


def test_llama_int4_logits_match_jax():
    jm, params, tm = _int4_pair(seed=0)
    assert tm.model.layers[0].self_attn.q_proj.kernel_q.shape == (64, 32)
    ids = np.random.default_rng(1).integers(3, 512, size=(2, 11)).astype(np.int32)
    jl, _, _ = jax.jit(jm.apply)(params, jnp.asarray(ids))
    with torch.no_grad():
        tl, _, _ = tm(input_ids=torch.from_numpy(ids).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)


def test_llama_int4_cached_decode_step_matches_jax():
    jm, params, tm = _int4_pair(seed=2)
    rng = np.random.default_rng(3)
    ids = rng.integers(3, 512, size=(2, 9)).astype(np.int32)
    plen = np.array([9, 6], np.int32)
    nxt = rng.integers(3, 512, size=(2, 1)).astype(np.int32)
    jc = jL.init_kv_cache(jm.config, 2, 16)
    _, _, jc = jm.apply(params, jnp.asarray(ids), kv_write_index=0, kv_cache=jc,
                        kv_len=jnp.asarray(plen))
    jl, _, jc = jm.apply(params, jnp.asarray(nxt), positions=jnp.asarray(plen)[:, None],
                         kv_write_index=jnp.asarray(plen), kv_cache=jc,
                         kv_len=jnp.asarray(plen + 1))
    tc = tL.init_kv_cache(tm.config, 2, 16)
    tp = torch.from_numpy(plen)
    with torch.no_grad():
        tm(input_ids=torch.from_numpy(ids).long(), kv_write_index=0, kv_cache=tc, kv_len=tp)
        tl, _, tc = tm(input_ids=torch.from_numpy(nxt).long(), positions=tp[:, None],
                       kv_write_index=tp, kv_cache=tc, kv_len=tp + 1)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    for j, t in zip(jc, tc):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-4, rtol=0)


def test_lora_dense_rejects_odd_int4_width():
    with pytest.raises(ValueError):
        tL.LoraDense(63, 8, quantization="int4")


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_random_init_quantized_spread_matches_scale(quant):
    # The random-init factory gives a quantized projection the spread of a
    # float one: the dequantised weights' std is within 10% of `scale`.
    dense = tL.LoraDense(512, 256, dtype=torch.float32, quantization=quant)
    factory.random_init_(dense, torch.Generator().manual_seed(0), scale=0.02)
    if quant == "int4":
        w = tQ.dequantize_int4(dense.kernel_q)
    else:
        w = dense.kernel_q.float()
    std = (w * dense.kernel_scale[:, None]).std().item()
    assert abs(std - 0.02) <= 0.1 * 0.02, std
    x = torch.randn(4, 512, generator=torch.Generator().manual_seed(1))
    assert dense(x).std().item() == pytest.approx(0.02 * 512 ** 0.5, rel=0.15)
