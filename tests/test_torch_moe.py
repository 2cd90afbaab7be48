"""The port's MoE FFN (spider_tpu_torch/parallel/moe.py) and the MoE Llama
(``LlamaMoEMLP``, the aux term of ``make_lm_train_step``) against
spider_tpu/parallel/moe.py and the JAX ``LlamaMoEMLP``.

Inputs and weights come from numpy seeds; fp32 on the CPU. Tolerances: the
gating's integer outputs (dispatch, which tokens are dropped) are equal;
combine weights and the aux term within 1e-6 (one fp32 softmax); the FFN
output and its gradients within 1e-5 (four fp32 einsums summed in another
order); the two-layer MoE Llama's logits within 1e-4, as the dense model's
in tests/test_torch_llama.py; the train step's loss within 1e-5 and its
gradient norm within 1e-4 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from spider_tpu.models import llama as jL
from spider_tpu.models.llama import cross_entropy_loss as jce
from spider_tpu.parallel import moe as jmoe
from spider_tpu_torch.models import llama as tL
from spider_tpu_torch.models.convert import load_jax_params
from spider_tpu_torch.parallel import moe as tmoe
from spider_tpu_torch.runners.train_step import build_optimizer, make_lm_train_step
from test_torch_llama import _params


def _gating_logits(T, E, seed):
    # Few experts against many tokens: capacity drops in every round.
    rng = np.random.default_rng(seed)
    return (2.0 * rng.standard_normal((T, E)) + np.array([1.5] + [0.0] * (E - 1))
            ).astype(np.float32)


@pytest.mark.parametrize("case", [(10, 4, 1.0, 1), (7, 3, 2.0, 2), (100, 8, 0.5, 2),
                                  (1, 4, 1.0, 1)])
def test_capacity_matches_jax(case):
    assert tmoe._capacity(*case) == jmoe._capacity(*case)


@pytest.mark.parametrize("top_k", [1, 2])
def test_topk_gating_matches_jax_with_capacity_drops(top_k):
    logits = _gating_logits(40, 4, seed=top_k)
    cap = 6
    jc, jd, ja = jmoe.topk_gating(jnp.asarray(logits), cap, top_k)
    tc, td, ta = tmoe.topk_gating(torch.from_numpy(logits), cap, top_k)
    assert td.dtype == torch.bool and tuple(td.shape) == (40, 4, cap)
    assert np.array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ta.item(), float(ja), atol=1e-6, rtol=0)
    kept = td.any(dim=(1, 2))
    assert not kept.all() and kept.any()           # the case does drop tokens
    assert (td.sum(dim=(0, 2)) <= cap).all()       # no expert over capacity
    if top_k == 2:                                 # kept gates of a token sum to 1
        s = tc.sum(dim=(1, 2))
        assert torch.allclose(s[s > 0], torch.ones_like(s[s > 0]), atol=1e-6)


def test_topk_gating_reference_cases():
    # The JAX test's hand-made case: 4 tokens for expert 0 at capacity 2.
    logits = torch.tensor([[5.0, 0.0]] * 4 + [[0.0, 5.0]] * 2)
    _, d, aux = tmoe.topk_gating(logits, 2, 1)
    assert d[0, 0, 0] and d[1, 0, 1] and not d[2].any() and not d[3].any()
    assert d[4, 1, 0] and d[5, 1, 1] and aux.item() > 0


def _moe_inputs(cfg, T, seed):
    rng = np.random.default_rng(seed)
    M, F, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {"wg": (rng.standard_normal((M, E)) / np.sqrt(M)).astype(np.float32),
         "w1": (rng.standard_normal((E, M, F)) / np.sqrt(M)).astype(np.float32),
         "w2": (rng.standard_normal((E, F, M)) / np.sqrt(F)).astype(np.float32)}
    return p, rng.standard_normal((T, M)).astype(np.float32)


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_local_and_its_gradients_match_jax(top_k):
    jcfg = jmoe.MoEConfig(num_experts=4, d_model=16, d_ff=32, capacity_factor=0.25, top_k=top_k)
    tcfg = tmoe.MoEConfig(num_experts=4, d_model=16, d_ff=32, capacity_factor=0.25, top_k=top_k)
    p, x = _moe_inputs(jcfg, 24, seed=10 + top_k)

    def jloss(params, x):
        o, a = jmoe.moe_ffn_local(params, x, jcfg)
        return jnp.sum(o ** 2) + 0.01 * a, (o, a)

    (_, (jo, ja)), (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    to, ta = tmoe.moe_ffn_local(tp, tx, tcfg)
    ((to ** 2).sum() + 0.01 * ta).backward()
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ta.item(), float(ja), atol=1e-6, rtol=0)
    for k in p:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[k]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=1e-5, rtol=0)
    # a token past capacity in every round gets exactly zero from the FFN
    cap = tmoe._capacity(24, 4, 0.25, top_k)
    logits = torch.from_numpy(x) @ tp["wg"].detach()
    _, d, _ = tmoe.topk_gating(logits, cap, top_k)
    dropped = ~d.any(dim=(1, 2))
    assert dropped.any() and (to.detach()[dropped] == 0).all()
    assert (to.detach()[~dropped].abs().sum(-1) > 0).all()


def test_eval_capacity_factor_when_not_training():
    cfg = tmoe.MoEConfig(num_experts=4, d_model=8, d_ff=16, capacity_factor=0.25,
                         eval_capacity_factor=4.0)
    p, x = _moe_inputs(cfg, 32, seed=3)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jo, _ = jmoe.moe_ffn_local({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                               jmoe.MoEConfig(num_experts=4, d_model=8, d_ff=16,
                                              capacity_factor=0.25, eval_capacity_factor=4.0),
                               train=False)
    to, _ = tmoe.moe_ffn_local(tp, torch.from_numpy(x), cfg, train=False)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5, rtol=0)
    assert (to.abs().sum(-1) > 0).all()            # room for every token


def test_init_moe_params_shapes_and_spread():
    cfg = tmoe.MoEConfig(num_experts=3, d_model=64, d_ff=256, dtype=torch.bfloat16)
    p = tmoe.init_moe_params(cfg, torch.Generator().manual_seed(0))
    assert p["wg"].shape == (64, 3) and p["wg"].dtype == torch.float32
    assert p["w1"].shape == (3, 64, 256) and p["w2"].shape == (3, 256, 64)
    assert p["w1"].dtype == p["w2"].dtype == torch.bfloat16
    assert abs(p["w2"].float().std().item() - 1 / 16) < 5e-3


def _moe_pair(top_k, seed):
    fields = dict(num_experts=4, moe_top_k=top_k, moe_capacity_factor=1.0)
    jm = jL.LlamaForCausalLM(dataclasses.replace(jL.llama_tiny(vocab_size=128), **fields))
    # the init tree also holds a "losses" collection: keep the parameters only
    params = {"params": _params(jm, seed)["params"]}
    tm = tL.LlamaForCausalLM(dataclasses.replace(tL.llama_tiny(vocab_size=128), **fields))
    load_jax_params(tm, params)
    return jm, params, tm


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_llama_forward_and_aux_match_jax(top_k):
    jm, params, tm = _moe_pair(top_k, seed=20 + top_k)
    mlp = tm.model.layers[0].mlp
    assert isinstance(mlp, tL.LlamaMoEMLP) and mlp.wg.dtype == torch.float32
    assert tuple(mlp.w1.shape) == (4, 64, 128) and tuple(mlp.w2.shape) == (4, 128, 64)
    ids = np.random.default_rng(30).integers(3, 128, size=(2, 12)).astype(np.int32)
    (jl, _, _), mut = jm.apply(params, jnp.asarray(ids), mutable=["losses"])
    jaux = np.asarray(jax.tree_util.tree_leaves(mut["losses"])[0])
    with torch.no_grad():
        tl, _, _ = tm(input_ids=torch.from_numpy(ids).long())
    taux = tm.moe_aux_losses()
    assert taux.shape == jaux.shape == (2,)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    np.testing.assert_allclose(taux.numpy(), jaux, atol=1e-6, rtol=0)


def test_dense_llama_has_no_aux():
    assert tL.LlamaForCausalLM(tL.llama_tiny()).moe_aux_losses() is None


def test_moe_lm_train_step_loss_and_gradients_match_jax():
    # make_lm_train_step adds moe_aux_weight * mean over layers of the aux
    # term, as the JAX step does; the gradient norm (before clipping) covers
    # every parameter, the experts and the gate included.
    jm, params, tm = _moe_pair(2, seed=40)
    rng = np.random.default_rng(41)
    ids = rng.integers(3, 128, size=(2, 10)).astype(np.int32)
    labels = np.where(rng.random((2, 10)) < 0.3, -100, ids).astype(np.int64)

    def loss_fn(p):
        (logits, _, _), mut = jm.apply(p, jnp.asarray(ids), mutable=["losses"])
        aux = sum(jnp.mean(x) for x in jax.tree_util.tree_leaves(mut["losses"]))
        loss, _ = jce(logits, jnp.asarray(labels))
        return loss + jm.config.moe_aux_weight * aux, aux

    (jloss, jaux), jg = jax.value_and_grad(loss_fn, has_aux=True)(params)
    opt = build_optimizer(1e-3, params=dict(tm.named_parameters()), max_grad_norm=0.0)
    metrics = make_lm_train_step(tm, opt)(dict(input_ids=torch.from_numpy(ids),
                                               labels=torch.from_numpy(labels)))
    np.testing.assert_allclose(metrics["loss"].item(), float(jloss), atol=1e-5, rtol=0)
    np.testing.assert_allclose(metrics["moe_aux"].item(), float(jaux), atol=1e-6, rtol=0)
    np.testing.assert_allclose(metrics["grad_norm"].item(), float(optax.global_norm(jg)),
                               rtol=1e-4)
    assert opt.count == 1
