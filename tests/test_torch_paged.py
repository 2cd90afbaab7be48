"""Parity of the port's paged decode attention and paged decode step with the
JAX package.

Inputs are made with numpy from a seed, in fp32 on the CPU. The port's
``paged_decode_attention`` (its plain version on CPU tensors) is held to the
JAX Pallas kernel in interpret mode at 2e-5, the bound
tests/test_misc_ops.py holds the Pallas kernel to its gather reference. A
paged decode step of ``llama_tiny`` (weights through ``load_jax_params``) is
held to the JAX model's paged step, which takes the gather route off the
TPU, at 1e-4 on logits and pools, as tests/test_torch_llama.py holds the
contiguous step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spider_tpu.models import llama as jL
from spider_tpu.ops.paged_attention import paged_decode_attention as j_paged
from spider_tpu_torch.models import llama as tL
from spider_tpu_torch.models.convert import load_jax_params
from spider_tpu_torch.ops import paged_attention as tP


@pytest.mark.parametrize("kv_len", [[5, 16, 32], [1, 33, 40]])
def test_paged_attention_equals_pallas_interpret(kv_len):
    # tests/test_misc_ops.py's shapes; the second case has a slot past the
    # table (40 > max_pages * page = 32), whose window is every key.
    B, Hq, Hkv, D, page, MP, NB = 3, 8, 2, 16, 8, 4, 12
    rng = np.random.default_rng(0)
    q = rng.normal(0, 1, (B, Hq, D)).astype(np.float32)
    pool_k = rng.normal(0, 1, (NB, page, Hkv, D)).astype(np.float32)
    pool_v = rng.normal(0, 1, (NB, page, Hkv, D)).astype(np.float32)
    table = rng.permutation(NB)[: B * MP].reshape(B, MP).astype(np.int32)
    lens = np.asarray(kv_len, np.int32)
    want = j_paged(jnp.asarray(q), jnp.asarray(pool_k), jnp.asarray(pool_v),
                   jnp.asarray(table), jnp.asarray(lens), interpret=True)
    got = tP.paged_decode_attention(*(torch.from_numpy(a) for a in
                                      (q, pool_k, pool_v, table, lens)))
    assert got.shape == (B, Hq, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_plain_mode_routes_to_the_reference():
    rng = np.random.default_rng(1)
    q, pk, pv = (torch.from_numpy(rng.normal(0, 1, s).astype(np.float32))
                 for s in ((2, 4, 8), (6, 4, 2, 8), (6, 4, 2, 8)))
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    lens = torch.tensor([3, 8], dtype=torch.int32)
    with tP.paged_decode_config("plain"):
        got = tP.paged_decode_attention(q, pk, pv, table, lens)
    torch.testing.assert_close(got, tP.paged_decode_reference(q, pk, pv, table, lens))
    with pytest.raises(ValueError):
        with tP.paged_decode_config("fast"):
            pass


def _params(jm, seed):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))

    def fill(path, s):
        key = jax.tree_util.keystr(path)
        x = 0.05 * rng.standard_normal(s.shape, dtype=np.float32)
        return x + 1.0 if "layernorm" in key or key.endswith("['norm']") else x

    return jax.tree_util.tree_map_with_path(fill, shapes)


def test_paged_decode_step_matches_jax_and_drops_out_of_range_writes():
    jm = jL.LlamaForCausalLM(jL.llama_tiny())
    params = _params(jm, seed=0)
    tm = tL.LlamaForCausalLM(tL.llama_tiny()).eval()
    load_jax_params(tm, params)
    cfg = tm.config
    L, Hkv, D = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim_
    page, MP, NB = 4, 3, 12
    rng = np.random.default_rng(1)
    pools = [(0.5 * rng.standard_normal((L, NB, page, Hkv, D))).astype(np.float32)
             for _ in range(2)]
    # Distinct blocks per slot; block 0 (the batcher's scratch) unused.
    table = (1 + rng.permutation(NB - 1)[: 3 * MP]).reshape(3, MP).astype(np.int32)
    # Slot 2 writes at position 12 = max_pages * page: logical page 3 has no
    # block, so its write is dropped, and it attends its whole window.
    idx = np.array([5, 11, 12], np.int32)
    tok = rng.integers(3, 512, size=(3, 1)).astype(np.int32)

    jl, _, (jk, jv) = jm.apply(params, jnp.asarray(tok), positions=jnp.asarray(idx)[:, None],
                               kv_write_index=jnp.asarray(idx),
                               kv_cache=tuple(jnp.asarray(p) for p in pools),
                               kv_len=jnp.asarray(idx + 1), page_table=jnp.asarray(table))
    tk, tv = (torch.from_numpy(p.copy()) for p in pools)
    ti = torch.from_numpy(idx)
    with torch.no_grad():
        tl, _, cache = tm(input_ids=torch.from_numpy(tok).long(), positions=ti[:, None],
                          kv_write_index=ti, kv_cache=(tk, tv), kv_len=ti + 1,
                          page_table=torch.from_numpy(table))
    assert cache[0] is tk and cache[1] is tv           # updated in place
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4, rtol=0)
    # The two in-range writes landed; the dropped one changed nothing.
    changed = [(l, b, r) for l, b, r in zip(*np.nonzero(
        (tk.numpy() != pools[0]).any(axis=(-1, -2))))]
    assert sorted(changed) == sorted([(l, table[0, 1], 1) for l in range(L)]
                                     + [(l, table[1, 2], 3) for l in range(L)])


def test_paged_path_is_single_token():
    tm = tL.LlamaForCausalLM(tL.llama_tiny()).eval()
    pool = tL.init_paged_kv_cache(tm.config, 4, page=4)
    assert pool[0].shape == (2, 4, 4, 2, 16) and pool[0].dtype == torch.float32
    with pytest.raises(ValueError, match="single-token"):
        tm(input_ids=torch.ones(1, 2, dtype=torch.long), kv_write_index=torch.zeros(1),
           kv_cache=pool, kv_len=torch.ones(1), page_table=torch.ones(1, 2, dtype=torch.int32))
