"""The port's continuous batchers and its wave batcher (``LlmBatcher``)
against its own greedy ``generate``.

``generate`` is held to the JAX package's by tests/test_torch_llama.py, so
every output here is checked against a fresh greedy decode of the same
prompt, never against the reference batcher: in the preempt-and-resume case
with one token of budget left the reference finishes one token short
(ROADMAP C3, spider_tpu/serving/continuous.py:265-269). Everything runs on
``llama_tiny`` in fp32 on the CPU with random weights from a seed; texts
must be equal.
"""

import threading

import pytest
import torch

from spider_tpu_torch.models import factory
from spider_tpu_torch.models import llama as tL
from spider_tpu_torch.models.decode import GenerateConfig, generate
from spider_tpu_torch.models.tokenizer import TinyTokenizer
from spider_tpu_torch.serving import batcher as batcher_mod
from spider_tpu_torch.serving.batcher import LlmBatcher
from spider_tpu_torch.serving.continuous import ContinuousBatcher, PagedContinuousBatcher

TOK = TinyTokenizer()


@pytest.fixture(scope="module")
def model():
    m = tL.LlamaForCausalLM(tL.llama_tiny(vocab_size=300)).eval()
    # A spread of 0.2 gives the random model varied, well-separated argmaxes.
    return factory.random_init_(m, torch.Generator().manual_seed(0), scale=0.2)


def _greedy_ids(model, prompt, n):
    ids = TOK(prompt, add_special_tokens=True).input_ids
    with torch.no_grad():
        emb = model.embed(torch.tensor([ids]))
    out = generate(model, emb, torch.tensor([len(ids)], dtype=torch.int32),
                   GenerateConfig(max_new_tokens=n, eos_ids=(TOK.eos_token_id,),
                                  pad_id=TOK.pad_token_id))
    return out["tokens"][0].tolist()


def _greedy(model, prompt, n):
    toks = [t for t in _greedy_ids(model, prompt, n) if t != TOK.pad_token_id]
    return TOK.decode(toks, skip_special_tokens=True)


def _manual(cb):
    """Stop the serving thread so that the test drives the ticks itself."""
    cb._stop = True
    cb._thread.join(timeout=10)
    assert not cb._thread.is_alive()
    return cb


def _drive(cb, futs, max_ticks=400):
    for _ in range(max_ticks):
        if all(f.done() for f in futs):
            break
        cb._tick()
    return [f.result(timeout=0) for f in futs]


def test_contiguous_batcher_matches_generate(model):
    cb = ContinuousBatcher(model, TOK, num_slots=2, max_len=64, max_new_tokens=5,
                           prefill_bucket=16)
    prompts = [f"prompt number {i}" for i in range(3)]     # 3 requests, 2 slots
    outs = [f.result(timeout=120) for f in [cb.submit(p) for p in prompts]]
    cb.close()
    assert not cb._thread.is_alive()
    assert outs == [_greedy(model, p, 5) for p in prompts]
    assert cb.n_prefills == 3 and cb.n_decode_steps % cb.decode_steps == 0


def test_paged_batcher_mixed_lengths_reuse_slots_and_drain(model):
    cb = PagedContinuousBatcher(model, TOK, num_slots=2, max_len=64, max_new_tokens=6,
                                prefill_bucket=16, page=16, num_blocks=6)
    prompts = ["hi", "prompt number one is longer than the others by far",
               "medium sized prompt here", "tail request"]
    outs = [f.result(timeout=120) for f in [cb.submit(p) for p in prompts]]
    cb.close()
    # every page comes back (block 0 is the scratch block, never allocated)
    assert sorted(cb._free) == list(range(1, 7))
    assert outs == [_greedy(model, p, 6) for p in prompts]


def test_paged_batcher_pool_exhaustion_preempts_not_hangs(model):
    # The prompts prefill into 3 + 4 pages, filling the 7-block pool; the
    # first page-boundary crossing finds no free block and must preempt.
    # Ticks are driven by hand so that both are admitted in one tick.
    cb = _manual(PagedContinuousBatcher(model, TOK, num_slots=2, max_len=48,
                                        max_new_tokens=12, prefill_bucket=8, page=8,
                                        num_blocks=7))
    prompts = ["one two three four five", "six seven eight nine ten", "short tail"]
    outs = _drive(cb, [cb.submit(p) for p in prompts])
    assert cb.n_preempts > 0
    assert sorted(cb._free) == list(range(1, 8))
    assert outs == [_greedy(model, p, 12) for p in prompts]


def test_resumed_request_with_one_token_left_is_whole(model):
    # One tick emits the first token and a chunk of 8: 9 of 10. Preempted
    # then, the request resumes with one token of budget, which is its
    # pending first token when the next tick's finish check runs.
    prompt, n = "a horse on the beach", 10
    want = _greedy_ids(model, prompt, n)
    assert TOK.eos_token_id not in want and TOK.pad_token_id not in want
    cb = _manual(PagedContinuousBatcher(model, TOK, num_slots=1, max_len=64,
                                        max_new_tokens=n, prefill_bucket=16, page=16))
    fut = cb.submit(prompt)
    cb._tick()
    req = cb._requests[0]
    assert req.emitted == want[:9]
    with torch.inference_mode():
        cb._preempt(0)
    cb._tick()                       # re-admitted with budget 0, then finished
    assert fut.done() and cb.n_preempts == 1
    assert req.emitted == want
    assert fut.result(timeout=0) == _greedy(model, prompt, n)
    assert cb._pending_tok0 == [] and sorted(cb._free) == list(range(1, 5))


def test_finish_takes_the_pending_first_token(model):
    # _finish on a slot whose first token is still on the device: the text
    # holds that token and no stale pending entry stays behind.
    cb = _manual(ContinuousBatcher(model, TOK, num_slots=1, max_len=32, max_new_tokens=1,
                                   prefill_bucket=16))
    fut = cb.submit("cat")
    with torch.inference_mode():
        cb._admit(cb._queue.get_nowait(), 0)
        assert len(cb._pending_tok0) == 1
        cb._finish(0)
    assert cb._pending_tok0 == []
    assert fut.result(timeout=0) == _greedy(model, "cat", 1)


@pytest.mark.parametrize("paged", [True, False])
def test_request_into_max_len_over_decodes_past_the_table(model, paged):
    # 20 prompt tokens + 12 new = max_len 32: the last chunk of 8 decodes
    # past position 31, so the paged pool's writes pass the 4-page table
    # (dropped) and the contiguous cache's writes clamp to its last row.
    prompt = "a horse on a beach"            # 19 bytes + bos
    want = _greedy_ids(model, prompt, 12)
    assert TOK.eos_token_id not in want
    kw = dict(num_slots=2, max_len=32, max_new_tokens=12, prefill_bucket=8)
    cb = _manual(PagedContinuousBatcher(model, TOK, page=8, **kw) if paged
                 else ContinuousBatcher(model, TOK, **kw))
    futs = [cb.submit(prompt), cb.submit("hi")]
    furthest = 0
    for _ in range(20):
        if all(f.done() for f in futs):
            break
        cb._tick()
        furthest = max(furthest, int(cb._kv_len_host.max()))
    assert furthest > cb.max_len
    assert [f.result(timeout=0) for f in futs] == [_greedy(model, prompt, 12),
                                                   _greedy(model, "hi", 12)]
    if paged:
        assert sorted(cb._free) == list(range(1, 9))


def test_paged_batcher_impossible_request_fails_fast(model):
    cb = PagedContinuousBatcher(model, TOK, num_slots=1, max_len=32, max_new_tokens=4,
                                prefill_bucket=4, page=4, num_blocks=1)
    fut = cb.submit("a prompt long enough to need three pages at page four "
                    "which can never fit")
    with pytest.raises(RuntimeError, match="never fit"):
        fut.result(timeout=60)
    cb.close()


def test_exception_in_the_loop_fails_every_future(model):
    cb = PagedContinuousBatcher(model, TOK, num_slots=2, max_len=32, max_new_tokens=4,
                                prefill_bucket=8, page=8)
    stepped, release = threading.Event(), threading.Event()

    def boom(mask):
        stepped.set()
        release.wait(timeout=30)     # fail once every request is in
        raise RuntimeError("device step failed")

    cb._step = boom
    futs = [cb.submit(f"request {i}") for i in range(3)]     # 2 slots: 1 waits
    release.set()
    for f in futs:
        with pytest.raises(RuntimeError, match="device step failed"):
            f.result(timeout=60)
    assert stepped.is_set()
    cb._thread.join(timeout=10)
    assert not cb._thread.is_alive() and cb._dead
    with pytest.raises(RuntimeError, match="terminated"):
        cb.submit("too late")


def test_paged_batcher_rejects_a_bucket_that_is_not_whole_pages(model):
    with pytest.raises(ValueError):
        PagedContinuousBatcher(model, TOK, num_slots=1, max_len=32, prefill_bucket=12,
                               page=8)


def test_llm_batcher_batches_and_answers(model):
    # 4 concurrent requests in one wave (the JAX test's case,
    # tests/test_serving.py:109-137); each answer equals a lone greedy decode,
    # and a single chat after the wave gives the first answer again.
    b = LlmBatcher(model, TOK, gen_cfg=GenerateConfig(max_new_tokens=4,
                                                      eos_ids=(TOK.eos_token_id,),
                                                      pad_id=TOK.pad_token_id),
                   max_batch_size=4, max_wait_s=0.2, length_bucket=16)
    prompts = [f"hello number {i}" + " and more" * i for i in range(4)]
    futs = [b.submit(p) for p in prompts]
    outs = [f.result(timeout=120) for f in futs]
    assert b.n_waves == 1
    assert outs == [_greedy(model, p, 4) for p in prompts]
    assert b.chat(prompts[0], timeout=120) == outs[0] and b.n_waves == 2
    b.close()
    assert not b._thread.is_alive()


def test_llm_batcher_pads_waves_to_the_bucket(model):
    b = LlmBatcher(model, TOK, max_batch_size=2, length_bucket=16)
    arr, plen = b.pad_wave([[5, 6, 7], list(range(1, 21))])
    assert arr.shape == (2, 32) and plen.tolist() == [3, 20]
    assert (arr[0, 3:] == TOK.pad_token_id).all() and arr[1, :20].tolist() == list(range(1, 21))
    b.close()


def test_llm_batcher_failing_wave_fails_its_futures_and_goes_on(model, monkeypatch):
    b = LlmBatcher(model, TOK, gen_cfg=GenerateConfig(max_new_tokens=3,
                                                      eos_ids=(TOK.eos_token_id,),
                                                      pad_id=TOK.pad_token_id),
                   max_batch_size=3, max_wait_s=0.2, length_bucket=16)
    real = batcher_mod.generate

    def boom(*a, **k):
        raise RuntimeError("wave failed")

    monkeypatch.setattr(batcher_mod, "generate", boom)
    futs = [b.submit(f"request {i}") for i in range(3)]
    for f in futs:
        with pytest.raises(RuntimeError, match="wave failed"):
            f.result(timeout=60)
    monkeypatch.setattr(batcher_mod, "generate", real)
    assert b.chat("request 0", timeout=60) == _greedy(model, "request 0", 3)
    b.close()
