"""Parity of the port's alignment projectors with the flax modules.

Weights come from the flax module's own init (a fixed key), as numpy through
load_jax_params; inputs are made with numpy from a seed. fp32 on the CPU at
small widths. Tolerance 2e-4: the same fp32 arithmetic in another summation
order through up to 6+6 pre-LN layers whose learned queries have unit
variance (outputs are O(1)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spider_tpu.models import aligner as jAl
from spider_tpu.models import aligners as jA
from spider_tpu_torch.models import aligner as tAl
from spider_tpu_torch.models import aligners as tA
from spider_tpu_torch.models.convert import load_jax_params

ATOL = 2e-4
SPECS = {"IMAGE": dict(alignment_output_tokens=5, alignment_output_dim=12),
         "AUDIO": dict(alignment_output_tokens=1, alignment_output_dim=8)}


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=ATOL, rtol=0)


@pytest.mark.parametrize("mode,tokens_in", [("linear", 3), ("transformer", 2), ("qformer", 2)])
def test_text_fc_layer_matches_flax(mode, tokens_in):
    kw = dict(num_input_tokens=tokens_in, num_output_tokens=3 if mode != "linear" else 2,
              mode=mode, hidden_dim=16)
    jm = jA.TextFcLayer(24, 10, **kw)
    x = _x((2, tokens_in, 24))
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    tm = load_jax_params(tA.TextFcLayer(24, 10, **kw), params)
    _close(tm(torch.from_numpy(x)), jm.apply(params, jnp.asarray(x)))


def _init_all(jm, x, modalities):
    """flax creates a modality's parameters when it is first applied: merge
    the inits of every modality, as the JAX factory does."""
    params = {}
    for i, m in enumerate(modalities):
        p = jm.init(jax.random.PRNGKey(2 + i), jnp.asarray(x), modality=m)["params"]
        params = {**p, **params}
    return {"params": params}


@pytest.mark.parametrize("reconstruct,rec_tokens", [(False, 1024), (True, 6), (True, 1)])
def test_moe_transformer_matches_flax(reconstruct, rec_tokens):
    kw = dict(mode="moe_transformer", reconstruct_loss=reconstruct, num_expert_layers=1,
              hidden_dim=16, num_rec_tokens=rec_tokens)
    jm = jA.TextFcLayerMoE(24, SPECS, **kw)
    x = _x((2, 3, 24), seed=1)
    params = _init_all(jm, x, SPECS)
    tm = load_jax_params(tA.TextFcLayerMoE(24, SPECS, **kw), params)
    for m in SPECS:
        want = jm.apply(params, jnp.asarray(x), modality=m)
        got = tm(torch.from_numpy(x), modality=m)
        if reconstruct:
            assert got[1].shape == (2, 3, 24)
            _close(got[0], want[0])
            _close(got[1], want[1])
        else:
            assert got.shape == (2, SPECS[m]["alignment_output_tokens"],
                                 SPECS[m]["alignment_output_dim"])
            _close(got, want)


def test_moe_transformer_long_input_returns_it_unreconstructed():
    kw = dict(mode="moe_transformer", reconstruct_loss=True, num_expert_layers=1,
              hidden_dim=16, num_rec_tokens=2)
    jm = jA.TextFcLayerMoE(24, SPECS, **kw)
    x = _x((1, 3, 24), seed=2)
    params = _init_all(jm, _x((1, 2, 24)), SPECS)
    tm = load_jax_params(tA.TextFcLayerMoE(24, SPECS, **kw), params)
    out, rec = tm(torch.from_numpy(x), modality="IMAGE")
    _close(out, jm.apply(params, jnp.asarray(x), modality="IMAGE")[0])
    np.testing.assert_array_equal(rec.numpy(), x)


@pytest.mark.parametrize("reconstruct", [False, True])
def test_moe_aligner_matches_flax(reconstruct):
    kw = dict(mode="moe_aligner", reconstruct_loss=reconstruct)
    jm = jA.TextFcLayerMoE(24, SPECS, **kw)
    x = _x((1, 4, 24), seed=3)
    params = jm.init(jax.random.PRNGKey(5), jnp.asarray(x))
    tm = load_jax_params(tA.TextFcLayerMoE(24, SPECS, **kw), params)
    want = jm.apply(params, jnp.asarray(x))
    got = tm(torch.from_numpy(x))
    if reconstruct:
        _close(got[0], want[0])
        _close(got[1], want[1])
    else:
        assert got.shape == (1, 77, 768)
        _close(got, want)


def test_aligner_losses_match_flax():
    jcfg = jAl.AlignerConfig(llm_dim=24, clip_dim=16, num_queries=7, max_positions=32)
    tcfg = tAl.AlignerConfig(llm_dim=24, clip_dim=16, num_queries=7, max_positions=32)
    cond, clip = _x((2, 5, 24), seed=4), _x((2, 7, 16), seed=5)
    pad = np.zeros((2, 5), np.float32)
    pad[1, 3:] = 1.0
    jm = jAl.Aligner(jcfg)
    params = jm.init(jax.random.PRNGKey(6), jnp.asarray(cond), jnp.asarray(clip))
    tm = load_jax_params(tAl.Aligner(tcfg), params)
    want = jm.apply(params, jnp.asarray(cond), jnp.asarray(clip), jnp.asarray(pad))
    got = tm(torch.from_numpy(cond), torch.from_numpy(clip), torch.from_numpy(pad))
    assert set(got) == set(want) == {"aligned", "mse_loss", "rec_loss"}
    for k in want:
        _close(got[k], want[k])
    # the inference-only half shares the encoder's parameters
    je = jAl.AlignerEncoder(jcfg)
    eparams = je.init(jax.random.PRNGKey(7), jnp.asarray(cond))
    te = load_jax_params(tAl.AlignerEncoder(tcfg), eparams)
    _close(te(torch.from_numpy(cond)), je.apply(eparams, jnp.asarray(cond)))
