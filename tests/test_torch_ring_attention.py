"""spider_tpu_torch/ops/ring_attention.py against spider_tpu/ops/ring_attention.py.

A 4-rank gloo world (tests/torch_dist_ranks.py::ring_world) runs the port's
ring; the parent holds it against the JAX ring over a context axis of 4 of
the 8 virtual CPU devices (forward within 2e-4) and its gradients against
jax.grad of the attention the JAX ring is held to (mha_reference, within
1e-3, as tests/test_ring_attention.py holds the JAX ring's), and against the port's one-process form of every rank's steps (the
same bits). The context-parallel Llama forward is held to the JAX model
within 2e-3 (tests/test_parallel.py:158).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spider_tpu.common import dist as jdist
from spider_tpu.models import llama as jL
from spider_tpu.ops.attention import mha_reference as jmha
from spider_tpu.ops.ring_attention import ring_attention as jring
from spider_tpu_torch.ops import attention as A
from spider_tpu_torch.ops import ring_attention as R
from torch_dist_ranks import run_world

N = 4
CASES = {  # name: (B, T, Hq, Hkv, D, causal)
    "causal": (1, 64, 2, 2, 16, True),
    "full": (1, 64, 2, 2, 16, False),
    "gqa": (2, 32, 4, 2, 8, True),
}


def _inputs(name):
    B, T, Hq, Hkv, D, causal = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(B, T, Hq, D), f(B, T, Hkv, D), f(B, T, Hkv, D), f(B, T, Hq, D), causal


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases = [_inputs(n) for n in CASES]
    m = jL.LlamaForCausalLM(jL.llama_tiny(vocab_size=64))
    ids = np.random.default_rng(7).integers(0, 64, (1, 32))
    params = jax.tree_util.tree_map(np.asarray, m.init(jax.random.PRNGKey(0), jnp.asarray(ids)))
    res = run_world("ring_world", N, tmp_path_factory.mktemp("ring"),
                    ring=dict(cases=cases), cp=dict(params=params, ids=ids))
    return dict(cases=cases, res=res, params=params, ids=ids, model=m)


def _gathered(world, i, key):
    return torch.cat([r["ring"][i][key] for r in world["res"]], dim=1).numpy()


@pytest.fixture(scope="module")
def jmesh():
    return jdist.make_mesh(data=1, context=N, devices=jax.devices()[:N])


@pytest.mark.parametrize("name", list(CASES))
def test_ring_forward_matches_the_jax_ring(world, jmesh, name):
    i = list(CASES).index(name)
    q, k, v, _, causal = world["cases"][i]
    want = jring(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jmesh, causal=causal)
    np.testing.assert_allclose(_gathered(world, i, "out"), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", list(CASES))
def test_ring_gradients_match_jax_grad(world, name):
    i = list(CASES).index(name)
    q, k, v, g, causal = world["cases"][i]

    def loss(q, k, v):
        return jnp.sum(jmha(q, k, v, causal=causal) * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for key, w in zip(("dq", "dk", "dv"), want):
        np.testing.assert_allclose(_gathered(world, i, key), np.asarray(w), rtol=1e-3, atol=1e-3,
                                   err_msg=key)


@pytest.mark.parametrize("name", list(CASES))
def test_one_process_rank_steps_give_the_gloo_rings_bits(world, name):
    i = list(CASES).index(name)
    q, k, v, g, causal = world["cases"][i]
    T = q.shape[1] // N
    split = lambda a: [torch.from_numpy(np.ascontiguousarray(a[:, r * T:(r + 1) * T]))
                       for r in range(N)]
    outs, _, dqs, dks, dvs = R.ring_attention_ranks(split(q), split(k), split(v), split(g),
                                                    causal=causal)
    for r, res in enumerate(world["res"]):
        got = res["ring"][i]
        for key, want in (("out", outs[r]), ("dq", dqs[r]), ("dk", dks[r]), ("dv", dvs[r])):
            assert torch.equal(got[key], want), (r, key)


def test_context_parallel_llama_forward_matches_jax(world):
    want, _, _ = world["model"].apply(world["params"], jnp.asarray(world["ids"]))
    got = torch.cat([r["cp"] for r in world["res"]], dim=1).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("causal", [True, False])
def test_a_ring_of_one_is_flash_attention(causal):
    q, k, v, g, _ = _inputs("gqa")
    leaves = lambda: [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    a, b = leaves(), leaves()
    out = R.ring_attention(*a, None, causal=causal)
    # on the CPU flash_attention_with_lse is the plain form the ring's block
    # takes; flash_attention's softmax form rounds differently
    want = A.flash_attention_with_lse(*b, causal=causal)[0]
    assert torch.equal(out, want)
    torch.testing.assert_close(out, A.flash_attention(*leaves(), causal=causal), rtol=1e-6,
                               atol=1e-6)
    out.backward(torch.from_numpy(g))
    want.backward(torch.from_numpy(g))
    for x, y in zip(a, b):
        torch.testing.assert_close(x.grad, y.grad, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dead_lse", [float("-inf"), A.DEFAULT_MASK_VALUE])
def test_a_dead_block_leaves_the_merge_bit_unchanged(dead_lse):
    """A block with no live key (lse -inf on the CPU, about -0.7 FLT_MAX
    from the CUDA kernel) merged into a finite running output."""
    rng = np.random.default_rng(3)
    o_run = torch.from_numpy(rng.standard_normal((1, 8, 2, 4)).astype(np.float32))
    lse_run = torch.from_numpy(rng.standard_normal((1, 2, 8)).astype(np.float32))
    o_b = torch.from_numpy(rng.standard_normal((1, 8, 2, 4)).astype(np.float32))
    o, lse = R.merge(o_run, lse_run, o_b, torch.full_like(lse_run, dead_lse))
    assert torch.equal(o, o_run) and torch.equal(lse, lse_run)


@pytest.mark.parametrize("rel_blocks", [-1, 0, 1])
def test_ring_block_is_the_plain_form_at_its_offset(rel_blocks):
    """The block step at q_offset -T_local, 0, +T_local (the three kinds of
    ring block) against attention over the whole key range it stands for."""
    q, k, v, g, _ = _inputs("gqa")
    T = q.shape[1]
    t = lambda a: torch.from_numpy(a)
    o, lse = R.ring_block(t(q), t(k), t(v), rel_blocks * T, causal=True)
    want, want_lse = A.mha_reference_with_lse(t(q), t(k), t(v), causal=True,
                                              q_offset=rel_blocks * T)
    assert torch.equal(lse, want_lse)
    live = torch.isfinite(want_lse).transpose(1, 2)[..., None].expand_as(o)
    assert torch.equal(o[live], want[live])
    if rel_blocks < 0:
        assert not live.any()
    if rel_blocks > 0:
        assert live.all()
