"""Prompt-lookup speculative decoding, token streaming and ``make_generate_fn``
in the port (models/speculative.py, models/decode.py) and the speculative
chat function, against the port's stepped greedy ``generate`` and the JAX
package.

fp32 on the CPU at llama_tiny width, weights from numpy through
``load_jax_params``, as tests/test_torch_llama.py. Greedy streams are held
token for token (as tests/test_llama.py holds the JAX ones): the verify
window and the stepped decode compute the same fp32 logits up to summation
order, far inside these models' top-2 gaps.
"""

import numpy as np
import pytest
import torch

from spider_tpu.models import llama as jL
from spider_tpu.models import speculative as jspec
from spider_tpu_torch.models import decode as tdecode
from spider_tpu_torch.models import llama as tL
from spider_tpu_torch.models import speculative as tspec
from spider_tpu_torch.models.convert import load_jax_params
from spider_tpu_torch.models.tokenizer import TinyTokenizer
from test_torch_llama import _params

EOS = 63
REPEATING = [3, 9, 4, 7, 3, 9, 4, 7, 3, 9]          # the JAX tests' prompt


@pytest.fixture(scope="module")
def pair():
    jm = jL.LlamaForCausalLM(jL.llama_tiny(vocab_size=64))
    params = _params(jm, 0)
    tm = tL.LlamaForCausalLM(tL.llama_tiny(vocab_size=64))
    load_jax_params(tm, params)
    return jm, params, tm.eval()


def _greedy(tm, ids, n, eos=(EOS,)):
    """The port's stepped greedy stream, cut after its first eos."""
    with torch.inference_mode():
        emb = tm.embed(torch.tensor([ids]))
    out = tdecode.generate(tm, emb, torch.tensor([len(ids)], dtype=torch.int32),
                           tdecode.GenerateConfig(max_new_tokens=n, eos_ids=eos))
    toks = out["tokens"][0].tolist()
    for e in eos:
        if e in toks:
            toks = toks[:toks.index(e) + 1]
    return toks


@pytest.mark.parametrize("seed", range(4))
def test_propose_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        seq = rng.integers(0, 5, size=rng.integers(1, 30)).tolist()
        n, k = int(rng.integers(1, 8)), int(rng.integers(1, 4))
        assert tspec.propose(seq, n, k, 0) == jspec.propose(seq, n, k, 0), (seq, n, k)


def test_propose_reference_cases():
    assert tspec.propose([1, 2, 3, 9, 8, 1, 2, 3], 2, 3, 0) == [9, 8]
    assert tspec.propose([5, 6, 7], 3, 3, 0) == [0, 0, 0]
    assert tspec.propose([4, 4], 2, 3, 0) == [4, 0]


@pytest.mark.parametrize("seed", range(3))
def test_propose_dev_matches_propose(seed):
    # The device form reads a buffer longer than the live prefix L.
    rng = np.random.default_rng(10 + seed)
    for _ in range(40):
        L = int(rng.integers(1, 24))
        buf = rng.integers(1, 5, size=32).astype(np.int32)
        n, k = int(rng.integers(1, 8)), int(rng.integers(1, 4))
        got = tspec.propose_dev(torch.from_numpy(buf), torch.tensor(L, dtype=torch.int32),
                                n, k, 0).tolist()
        assert got == tspec.propose(buf[:L].tolist(), n, k, 0), (buf[:L], n, k)


@pytest.mark.parametrize("gamma", [2, 4, 8])
def test_speculative_streams_equal_greedy_and_jax(pair, gamma):
    # The host loop, the on-device loop, the port's stepped greedy stream and
    # the JAX host loop: one stream, token for token.
    jm, params, tm = pair
    N = 24
    cfg = tspec.PromptLookupConfig(max_new_tokens=N, gamma=gamma, eos_ids=(EOS,), pad_id=0)
    want = _greedy(tm, REPEATING, N)
    host = tspec.speculative_generate(tm, REPEATING, cfg)
    dev = tspec.speculative_generate_ondevice(tm, REPEATING, cfg)
    assert host[:len(want)] == want and dev == host
    jcfg = jspec.PromptLookupConfig(max_new_tokens=N, gamma=gamma, eos_ids=(EOS,), pad_id=0)
    assert jspec.speculative_generate(jm, params, REPEATING, jcfg) == host


def test_speculative_random_prompt_and_eos(pair):
    # A prompt without repeats, and an eos id that the greedy stream hits:
    # the streams stop on it, eos included.
    _, _, tm = pair
    ids = np.random.default_rng(5).integers(1, 64, size=17).tolist()
    free = _greedy(tm, ids, 30, eos=())
    eos = free[11]
    want = free[:free.index(eos) + 1]
    cfg = tspec.PromptLookupConfig(max_new_tokens=30, gamma=4, eos_ids=(eos,))
    assert tspec.speculative_generate(tm, ids, cfg) == want
    assert tspec.speculative_generate_ondevice(tm, ids, cfg) == want


def test_draft_source_never_changes_the_stream(pair):
    # Oracle drafts (exact, corrupted, garbage) change acceptance only.
    _, _, tm = pair
    cfg = tspec.PromptLookupConfig(max_new_tokens=20, gamma=4, eos_ids=(EOS,))
    ref = tspec.speculative_generate_ondevice(tm, REPEATING, cfg)
    assert ref == _greedy(tm, REPEATING, 20)
    for kw in (dict(oracle=ref), dict(oracle=ref, corrupt_every=2), dict(oracle=[0] * 20),
               dict(oracle=list(range(20)))):
        assert tspec.speculative_generate_ondevice(tm, REPEATING, cfg, **kw) == ref, kw


def test_oracle_sets_the_windows(pair, monkeypatch):
    # A perfect oracle commits gamma tokens a window; a garbage one, one.
    _, _, tm = pair
    windows = []
    real = tspec._verify
    monkeypatch.setattr(tspec, "_verify", lambda *a: windows.append(1) or real(*a))
    cfg = tspec.PromptLookupConfig(max_new_tokens=17, gamma=4, eos_ids=())
    ref = tspec.speculative_generate_ondevice(tm, REPEATING, cfg, oracle=[0] * 17)
    assert len(windows) == 16                   # the first token comes from the prefill
    windows.clear()
    assert tspec.speculative_generate_ondevice(tm, REPEATING, cfg, oracle=ref) == ref
    assert len(windows) == 4                    # 16 tokens, 4 a window


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_stream_generate_equals_generate(pair, temperature):
    # Sampled streams draw from equally seeded generators in the same order.
    _, _, tm = pair
    ids = torch.tensor([np.random.default_rng(7).integers(1, 64, size=9).tolist()])
    with torch.inference_mode():
        emb = tm.embed(ids)
    gcfg = tdecode.GenerateConfig(max_new_tokens=12, temperature=temperature, top_p=0.9)
    plen = torch.tensor([9], dtype=torch.int32)
    want = tdecode.generate(tm, emb, plen, gcfg,
                            generator=torch.Generator().manual_seed(3))["tokens"][0].tolist()
    got = list(tdecode.stream_generate(tm, emb, plen, gcfg,
                                       generator=torch.Generator().manual_seed(3)))
    assert got == want and all(isinstance(t, int) for t in got)


def test_stream_generate_stops_at_eos_and_is_batch_one(pair):
    _, _, tm = pair
    ids = torch.tensor([REPEATING])
    with torch.inference_mode():
        emb = tm.embed(ids)
    free = _greedy(tm, REPEATING, 12, eos=())
    gcfg = tdecode.GenerateConfig(max_new_tokens=12, eos_ids=(free[4],))
    got = list(tdecode.stream_generate(tm, emb, torch.tensor([10]), gcfg))
    assert got == free[:free.index(free[4]) + 1]
    with pytest.raises(ValueError):
        next(tdecode.stream_generate(tm, emb.expand(2, -1, -1), torch.tensor([10, 10]), gcfg))


def test_make_generate_fn_and_embed_fn(pair):
    _, _, tm = pair
    ids = torch.tensor([REPEATING, REPEATING[::-1]])
    with torch.inference_mode():
        emb = tm.embed(ids)
    plen = torch.tensor([10, 7], dtype=torch.int32)
    gcfg = tdecode.GenerateConfig(max_new_tokens=8)
    want = tdecode.generate(tm, emb, plen, gcfg)
    got = tdecode.make_generate_fn(tm, gcfg)(emb, plen)
    assert torch.equal(got["tokens"], want["tokens"])
    assert torch.equal(got["step_hidden"], want["step_hidden"])
    # embed_fn feeds each step; the model's own table gives the same tokens,
    # another table other ones
    calls = []
    same = tdecode.generate(tm, emb, plen, gcfg, embed_fn=lambda t: calls.append(t) or tm.embed(t))
    assert torch.equal(same["tokens"], want["tokens"]) and len(calls) == 7
    other = tdecode.generate(tm, emb, plen, gcfg, embed_fn=lambda t: tm.embed(t) * 0.0)
    assert torch.equal(other["tokens"][:, 0], want["tokens"][:, 0])
    assert not torch.equal(other["tokens"], want["tokens"])


def test_speculative_chat_fn_equals_the_plain_one():
    from spider_tpu_torch.serving.spider_free import make_llama_chat_fn

    tok = TinyTokenizer()
    jm = jL.LlamaForCausalLM(jL.llama_tiny(vocab_size=300))
    tm = tL.LlamaForCausalLM(tL.llama_tiny(vocab_size=300))
    load_jax_params(tm, _params(jm, 4))
    tm.eval()
    prompt = "the horse runs on the beach, the horse runs on the"
    plain = make_llama_chat_fn(tm, tok, max_new_tokens=20)(prompt)
    spec = make_llama_chat_fn(tm, tok, max_new_tokens=20, speculative=True)(prompt)
    assert spec == plain and len(plain) > 0
