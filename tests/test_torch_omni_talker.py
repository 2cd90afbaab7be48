"""Parity of the port's Qwen2.5-Omni talker with the JAX package: the decoder's
logits, the sampler in HF's order, ``OmniTalkerGenerator.generate`` and the
talker rule set.

Weights: the JAX package's ``build_tiny_talker`` (fixed key) with N(0, 0.1)
noise added to every leaf, carried to the port through ``load_jax_params``;
streams and logits are made with numpy from seeds. fp32 on the CPU. Logits
are held to 1e-4 absolute; the reference draws with ``jax.random`` and the
port with a ``torch.Generator``, so sampled ids are compared only where the
sampler's result is forced (one id left with a nonzero probability), and
there they are equal; converted tensors are equal exactly.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spider_tpu.models import convert as JC
from spider_tpu.models import omni_talker as jt
from spider_tpu_torch.models import convert as TC
from spider_tpu_torch.models import omni_talker as tt
from spider_tpu_torch.models.convert import load_jax_params
from test_torch_grounding import _assert_same_state, _manifest, _np_tree, perturbed

ATOL = 1e-4


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _pair():
    module, params = jt.build_tiny_talker()
    params = perturbed(params, 4, scale=0.1)
    port = load_jax_params(tt.OmniTalker(tt.talker_tiny()), params).eval()
    return module, params, port


def _streams(P=7, R=5, seed=5):
    E = jt.talker_tiny().embedding_size
    prompt, reply = _x((P, E), seed), _x((R, E), seed + 1)
    bos, eos, pad = (_x((E,), seed + 2 + i) for i in range(3))
    T = P + 2
    pos = np.stack([np.arange(T), np.arange(T) // 2, np.arange(T) % 3])[:, None].astype(np.int32)
    return prompt, bos, reply, eos, pad, pos


def test_talker_logits_match_jax():
    module, params, port = _pair()
    x = _x((1, 9, module.config.embedding_size), 1)
    pos = np.stack([np.arange(9), np.arange(9) // 3, np.arange(9) % 2])[:, None].astype(np.int32)
    want, _ = jax.jit(module.apply)(params, jnp.asarray(x), positions=jnp.asarray(pos))
    with torch.no_grad():
        got, _ = port(torch.from_numpy(x), positions=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_bf16_parameters_give_the_products_of_fp32_ones():
    # The reference holds the talker's weights in fp32 and computes in bf16:
    # each product rounds the weight to bf16 first. Held in bf16 (the
    # full-size builders), the port makes the same products bit for bit.
    _, params, _ = _pair()
    cfg = dataclasses.replace(tt.talker_tiny(), dtype=torch.bfloat16)
    held32 = load_jax_params(tt.OmniTalker(cfg), params).eval()
    held16 = tt.OmniTalker(dataclasses.replace(cfg, param_dtype=torch.bfloat16)).eval()
    held16.load_state_dict(held32.state_dict())          # rounded to each tensor's dtype
    assert held16.codec_head.weight.dtype == torch.bfloat16
    assert held16.model.norm.dtype == torch.float32
    x = torch.from_numpy(_x((1, 6, cfg.embedding_size), 2))
    pos = torch.arange(6, dtype=torch.int32)[None, None].expand(3, 1, 6)
    with torch.no_grad():
        a, b = held32(x, pos)[0], held16(x, pos)[0]
    assert a.dtype == b.dtype == torch.bfloat16 and torch.equal(a, b)


# ---- the sampler ------------------------------------------------------------------

def _sampler_case(case, V=32):
    """(sampling, logits [V], presence [V], the forced id)."""
    cfg = jt.talker_tiny(V)
    logits = _x((V,), 9)
    presence = np.zeros(V, bool)
    presence[[cfg.codec_mask, cfg.codec_pad, cfg.codec_bos]] = True
    if case == "top_k_1":
        s = dict(top_k=1)
        want = None
    elif case == "penalty_moves_the_argmax":
        logits[3], logits[11] = 5.0, 4.9
        presence[3] = True             # 5 / 1.05 < 4.9
        s, want = dict(top_k=1), 11
    elif case == "bos_suppressed_at_the_argmax":
        logits[cfg.codec_bos], logits[17] = 9.0, 6.0
        s, want = dict(top_k=1), 17
    else:                                   # top_p keeps one id
        logits[20] = 12.0
        s, want = dict(top_k=0, top_p=0.5), 20
    return s, logits, presence, want, cfg


@pytest.mark.parametrize("case", ["top_k_1", "penalty_moves_the_argmax",
                                  "bos_suppressed_at_the_argmax", "top_p_keeps_one"])
def test_sampler_matches_the_reference_where_forced(case):
    s, logits, presence, want, cfg = _sampler_case(case)
    module = jt.OmniTalker(cfg)
    sample = jt.OmniTalkerGenerator(module, None, jt.TalkerSampling(**s))._build(4)[1]
    ref = int(sample(jnp.asarray(logits), jnp.asarray(presence), jax.random.PRNGKey(0)))
    kept = tt.filter_logits(torch.from_numpy(logits), torch.from_numpy(presence),
                            tt.TalkerSampling(**s), cfg.codec_bos)
    assert int(torch.isfinite(kept).sum()) == 1           # forced: one id is left
    got = tt.sample_codec(torch.from_numpy(logits), torch.from_numpy(presence),
                          tt.TalkerSampling(**s), cfg.codec_bos, torch.Generator().manual_seed(1))
    assert got == ref
    if want is not None:
        assert got == want


def test_sampler_keeps_the_reference_candidates_under_default_sampling():
    # HF's defaults leave several ids: the port keeps the reference's set,
    # and its draws come from a torch.Generator (the same seed, the same ids)
    s, logits, presence, _, cfg = _sampler_case("top_k_1", V=128)     # top-k 40 of 128
    ref = jt.TalkerSampling()
    pen = np.where(logits < 0, logits * ref.repetition_penalty, logits / ref.repetition_penalty)
    z = np.where(presence, pen, logits)
    z[cfg.codec_bos] = -np.inf
    z = z / ref.temperature
    z = np.where(z < np.sort(z)[::-1][ref.top_k - 1], -np.inf, z)
    srt = np.sort(z)[::-1]
    p = np.exp(srt - srt.max())
    cutoff = int((np.cumsum(p / p.sum()) < ref.top_p).sum())
    keep = np.isfinite(np.where(z < srt[cutoff], -np.inf, z))
    kept = torch.isfinite(tt.filter_logits(torch.from_numpy(logits), torch.from_numpy(presence),
                                           tt.TalkerSampling(), cfg.codec_bos)).numpy()
    np.testing.assert_array_equal(kept, keep)
    draw = lambda seed: [tt.sample_codec(torch.from_numpy(logits), torch.from_numpy(presence),
                                         tt.TalkerSampling(), cfg.codec_bos,
                                         g) for g in [torch.Generator().manual_seed(seed)] * 8]
    assert draw(3) == draw(3) and all(keep[i] for i in draw(3))


# ---- generate ------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["mrope_positions", "sequential", "empty_reply"])
def test_generate_with_top_k_1_matches_jax(case):
    module, params, port = _pair()
    prompt, bos, reply, eos, pad, pos = _streams()
    kw = dict(prefill_positions=pos)
    if case == "sequential":
        kw = {}
    elif case == "empty_reply":            # the thinker's EOS came first
        reply, kw = reply[:0], dict(prefill_positions=pos)
    want = jt.OmniTalkerGenerator(module, params, jt.TalkerSampling(top_k=1)).generate(
        prompt, bos, reply, eos, pad, max_new_tokens=12, **kw)
    got = tt.OmniTalkerGenerator(port, tt.TalkerSampling(top_k=1)).generate(
        prompt, bos, reply, eos, pad, max_new_tokens=12, **kw)
    assert got.dtype == np.int32 and len(got) >= 1
    np.testing.assert_array_equal(got, want)


def test_generate_budget_and_stops():
    # max_new_tokens steps after the first id: at most max_new_tokens + 1 ids,
    # none of them EOS or PAD; the same generator seed gives the same ids
    _, _, port = _pair()
    cfg = port.config
    prompt, bos, reply, eos, pad, pos = _streams(seed=21)
    gen = tt.OmniTalkerGenerator(port, tt.TalkerSampling(temperature=2.0, top_k=0, top_p=1.0,
                                                         repetition_penalty=1.0))
    runs = [gen.generate(prompt, bos, reply, eos, pad, prefill_positions=pos, max_new_tokens=3,
                         generator=torch.Generator().manual_seed(s)) for s in (0, 0, 1)]
    np.testing.assert_array_equal(runs[0], runs[1])
    for ids in runs:
        assert len(ids) <= 4 and not set(ids.tolist()) & {cfg.codec_eos, cfg.codec_pad}


# ---- rule set -------------------------------------------------------------------------

def _manifest_cfgs():
    jc = dataclasses.replace(jt.talker_tiny(), num_hidden_layers=28)
    tc = dataclasses.replace(tt.talker_tiny(), num_hidden_layers=28)
    return jc, tc


@functools.lru_cache(maxsize=None)
def _talker_sd(prefixed: bool):
    _, tc = _manifest_cfgs()
    module = tt.OmniTalker(tc)
    gen = torch.Generator().manual_seed(13)
    with torch.no_grad():
        for t in module.state_dict().values():
            t.copy_(torch.randn(t.shape, generator=gen))
    sd = TC.export_state_dict(TC.omni_talker_rules(_manifest("omni_talker"), tc),
                              module.state_dict())
    assert set(sd) == set(_manifest("omni_talker"))
    if prefixed:
        sd = {"talker." + k: v for k, v in sd.items()}
        sd["thinker.model.norm.weight"] = torch.ones(4)
    return {k: v.numpy() for k, v in sd.items()}


@pytest.mark.parametrize("prefixed", [False, True], ids=["bare", "talker"])
def test_talker_rules_match_the_reference_converter_bit_for_bit(prefixed):
    jc, tc = _manifest_cfgs()
    sd = _talker_sd(prefixed)
    want = load_jax_params(tt.OmniTalker(tc), _np_tree(JC.convert_omni_talker(sd, jc)))
    got = tt.OmniTalker(tc)
    rules = TC.omni_talker_rules(sd, tc)
    got.load_state_dict(TC.convert_state_dict(rules, sd), strict=True)
    _assert_same_state(got, want)
    assert {k for r in rules for k in r.keys} == {k for k in sd if k.startswith(
        "talker." if prefixed else "")}


def test_full_talker_reads_exactly_the_manifest():
    keys = set(_manifest("omni_talker"))
    module = tt.OmniTalker(tt.talker_full(), "meta")
    rules = TC.omni_talker_rules(keys, module.config)
    read = [k for r in rules for k in r.keys]
    filled = [n for r in rules for n in r.names]
    assert len(read) == len(set(read)) == len(keys) and set(read) == keys
    assert set(filled) == set(module.state_dict())
    state = module.state_dict()
    assert tuple(state["embed_tokens.weight"].shape) == (8448, 3584)
    assert tuple(state["codec_head.weight"].shape) == (8448, 3584)
