"""The MoE Llama under a training mesh (``LlamaMoEMLP`` through
``parallel/moe.py::moe_ffn_sharded``, ``runners/train_step.py``'s
``shard_model`` and ``make_lm_train_step``) against the one-process port
model on the global batch and the JAX ``LlamaForCausalLM``.

Two gloo worlds (tests/torch_dist_ranks.py::moe_llama_world): data 2 x
expert 2 (4 ranks: each data rank draws 2 of the 4 rows, its two expert
peers hold the same rows and 2 of the 4 experts each) and context 2 (2
ranks: each holds 8 of the 16 columns of every row). Each runs the tiny
Llama with 4 experts and LoRA (r 2) at top-1 and top-2, with a capacity
factor of 0.75, under which experts overflow and tokens are dropped (the
test asserts that some are).

Tolerances (fp32 on the CPU): logits within 1e-4 and the aux terms within
1e-6 of the one-process model, as tests/test_torch_moe.py holds the MoE
Llama to the JAX one; the step's loss within 1e-5, its gradient norm and the
LoRA, gate and expert gradients within 1e-4 (sums of the same products over
the ranks in another order); the tokens each layer keeps equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spider_tpu.models import llama as jL
from spider_tpu.models.llama import cross_entropy_loss as jce
from spider_tpu_torch.models import llama as tL
from spider_tpu_torch.models.convert import load_jax_params
from torch_dist_ranks import moe_llama_run, run_world

B, T, V = 4, 16, 64
FIELDS = {k: dict(num_experts=4, moe_top_k=k, moe_capacity_factor=0.75, intermediate_size=32)
          for k in (1, 2)}
WORLDS = {"data2_expert2": (4, dict(data=2, expert=2)), "context2": (2, dict(context=2))}


def _jax_model(top_k):
    return jL.LlamaForCausalLM(dataclasses.replace(jL.llama_tiny(vocab_size=V, lora_r=2),
                                                   **FIELDS[top_k]))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    # the parameter tree does not depend on top_k: one tree serves both
    m = _jax_model(1)
    shapes = jax.eval_shape(m.init, jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))
    rng = np.random.default_rng(60)
    params = {"params": jax.tree_util.tree_map(
        lambda s: (0.1 * rng.standard_normal(s.shape)).astype(np.float32),
        shapes["params"])}
    ids = rng.integers(3, V, (B, T))
    labels = ids.copy()
    labels[:, :3] = -100
    labels[1, 9:] = -100                # ranks hold different counts of live targets
    batch = dict(input_ids=ids, labels=labels)
    res = {name: run_world("moe_llama_world", n, tmp_path_factory.mktemp(name), params=params,
                           batch=batch, cases=[(mesh_kw, FIELDS[k]) for k in (1, 2)])
           for name, (n, mesh_kw) in WORLDS.items()}
    one = {}
    for k in (1, 2):
        cfg = dataclasses.replace(tL.llama_tiny(vocab_size=V, lora_r=2), **FIELDS[k])
        one[k] = moe_llama_run(load_jax_params(tL.LlamaForCausalLM(cfg), params), batch, None)
    return dict(params=params, batch=batch, res=res, one=one)


def _whole(name, key, ranks, mesh_kw):
    """The ranks' per-token tensors of `key` put back into [B, T, ...]
    (kept counts come per layer as [N_local])."""
    if "context" in mesh_kw:
        return torch.cat([r[key] for r in ranks], dim=1)
    return torch.cat([r[key] for r in ranks[::2]], dim=0)     # expert peers hold alike


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("top_k", [1, 2])
def test_sharded_moe_llama_forward_equals_the_one_process_model(setup, world, top_k):
    n, mesh_kw = WORLDS[world]
    ranks = [r[top_k - 1] for r in setup["res"][world]]
    one = setup["one"][top_k]
    logits = _whole(world, "logits", ranks, mesh_kw)
    torch.testing.assert_close(logits, one["logits"], atol=1e-4, rtol=0)
    for r in ranks:                                    # the global batch's, on every rank
        torch.testing.assert_close(r["aux"], one["aux"], atol=1e-6, rtol=0)
    for layer in range(len(one["kept"])):
        parts = [r["kept"][layer].reshape(-1, T // (2 if "context" in mesh_kw else 1))
                 for r in ranks]
        kept = (torch.cat(parts, dim=1) if "context" in mesh_kw
                else torch.cat(parts[::2], dim=0))
        want = one["kept"][layer].reshape(B, T)
        assert torch.equal(kept, want)
        assert (want < top_k).any() and (want > 0).any()     # the capacity drops tokens
    if world == "data2_expert2":
        assert ranks[0]["w1_place"][-1] == ("Shard", 0)     # over expert: two experts a rank


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("top_k", [1, 2])
def test_sharded_moe_step_gradients_equal_the_one_process_step(setup, world, top_k):
    ranks = [r[top_k - 1] for r in setup["res"][world]]
    one = setup["one"][top_k]
    for r in ranks:
        assert r["metrics"]["loss"] == pytest.approx(one["metrics"]["loss"], abs=1e-5)
        assert r["metrics"]["moe_aux"] == pytest.approx(one["metrics"]["moe_aux"], abs=1e-6)
        assert r["metrics"]["grad_norm"] == pytest.approx(one["metrics"]["grad_norm"],
                                                          rel=1e-4)
        assert set(r["grads"]) == set(one["grads"])
        checked = [n for n in one["grads"] if "lora_" in n or n.endswith(("mlp.w1", "mlp.w2",
                                                                        "mlp.wg"))]
        assert len(checked) == 2 * (8 + 3)
        for n in checked:
            torch.testing.assert_close(r["grads"][n], one["grads"][n], atol=1e-4, rtol=0)


@pytest.mark.parametrize("top_k", [1, 2])
def test_sharded_moe_llama_matches_the_jax_model(setup, top_k):
    """The JAX model on the global batch: logits, aux terms, the step's
    loss and the LoRA and expert gradients of loss + aux_weight * aux."""
    m = _jax_model(top_k)
    params = jax.tree_util.tree_map(jnp.asarray, setup["params"])
    ids = jnp.asarray(setup["batch"]["input_ids"], jnp.int32)
    labels = jnp.asarray(setup["batch"]["labels"])

    def loss_fn(p):
        (logits, _, _), mut = m.apply(p, ids, mutable=["losses"])
        aux = jax.tree_util.tree_leaves(mut["losses"])[0]
        loss, _ = jce(logits, labels)
        return loss + m.config.moe_aux_weight * jnp.mean(aux), (logits, aux, loss)

    (total, (jlogits, jaux, _)), jg = jax.value_and_grad(loss_fn, has_aux=True)(params)
    jflat = {jax.tree_util.keystr(k): np.asarray(v)
             for k, v in jax.tree_util.tree_leaves_with_path(jg)}
    for world, (_, mesh_kw) in WORLDS.items():
        ranks = [r[top_k - 1] for r in setup["res"][world]]
        logits = _whole(world, "logits", ranks, mesh_kw)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=0)
        np.testing.assert_allclose(ranks[0]["aux"].numpy(), np.asarray(jaux), atol=1e-6,
                                   rtol=0)
        assert ranks[0]["metrics"]["loss"] == pytest.approx(float(total), abs=1e-5)
        grads = ranks[0]["grads"]
        for i in range(2):
            w1 = jflat[f"['params']['model']['layers']['mlp']['w1']"][i]
            np.testing.assert_allclose(grads[f"model.layers.{i}.mlp.w1"].numpy(), w1,
                                       atol=1e-4, rtol=0)
            la = jflat[f"['params']['model']['layers']['self_attn']['q_proj']['lora_a']"][i]
            np.testing.assert_allclose(grads[f"model.layers.{i}.self_attn.q_proj.lora_a"].numpy(),
                                       la, atol=1e-4, rtol=0)
