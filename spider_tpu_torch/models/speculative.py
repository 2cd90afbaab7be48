"""Prompt-lookup speculative decoding: greedy decode at batch 1 that commits
several tokens per forward pass (counterpart of
spider_tpu/models/speculative.py).

Each window proposes the tokens that followed the latest earlier occurrence
of the current suffix n-gram (no draft model), then verifies the window
[current token, draft...] in ONE forward of G = gamma positions. Position i
of the window is committed while the draft agreed with the model's own
argmax before it, so the committed stream is the model's greedy stream:
speculation changes the cost, never the tokens. (In bf16 the window's
products may round otherwise than a single-token step's, which can flip a
near-tie between the two best tokens.)

``speculative_generate`` drives the windows from the host (the draft is
made in Python from the committed ids, one read of the window's argmaxes a
window). ``speculative_generate_ondevice`` keeps the proposal, the
verification, the acceptance and the commit as tensor operations on the
model's device over a token buffer [T + N + G]; the one host read a window
is its ``done`` flag. The verify forward writes the cache at kv_len and
reads it with kv_len + G live keys from q_offset kv_len: on the card that
is the flash kernel, where the stepped decode takes the plain attention.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from spider_tpu_torch.models.llama import LlamaForCausalLM, init_kv_cache


@dataclasses.dataclass(frozen=True)
class PromptLookupConfig:
    max_new_tokens: int = 512
    gamma: int = 8                 # verify window (1 carry + gamma-1 draft)
    max_ngram: int = 3             # longest suffix n-gram to match
    eos_ids: Tuple[int, ...] = ()
    pad_id: int = 0


def propose(seq: List[int], n: int, max_ngram: int, pad_id: int) -> List[int]:
    """Tokens that followed the most recent earlier occurrence of the
    current suffix n-gram (longest n first); pad_id-filled if no match."""
    L = len(seq)
    for k in range(min(max_ngram, L - 1), 0, -1):
        pat = seq[L - k:]
        for s in range(L - k - 1, -1, -1):
            if seq[s:s + k] == pat:
                cont = seq[s + k:s + k + n]
                if cont:
                    return cont + [pad_id] * (n - len(cont))
    return [pad_id] * n


def _prefill(model: LlamaForCausalLM, ids: List[int], max_len: int):
    """Cache [T + N + G] filled with the prompt; (first greedy token as a
    0-d int32 tensor on the device, cache)."""
    dev = model.device
    cache = init_kv_cache(model.config, 1, max_len, device=dev)
    arr = torch.tensor([ids], dtype=torch.long, device=dev)
    T = len(ids)
    logits, _, cache = model(inputs_embeds=model.embed(arr),
                             positions=torch.arange(T, dtype=torch.int32, device=dev)[None],
                             kv_write_index=0, kv_cache=cache,
                             kv_len=torch.tensor([T], dtype=torch.int32, device=dev))
    return logits[0, -1].argmax(-1).to(torch.int32), cache


def _verify(model: LlamaForCausalLM, cache, kv_len: torch.Tensor, window: torch.Tensor):
    """window [1, G] token ids at positions kv_len .. kv_len + G - 1
    (kv_len [1] int32 on the device); the model's argmax AFTER each window
    position, [G] int32."""
    G = window.shape[1]
    positions = kv_len[:, None] + torch.arange(G, dtype=torch.int32, device=window.device)[None]
    logits, _, cache = model(inputs_embeds=model.embed(window), positions=positions,
                             kv_write_index=kv_len, kv_cache=cache, kv_len=kv_len + G)
    return logits[0].argmax(-1).to(torch.int32)


@torch.inference_mode()
def speculative_generate(model: LlamaForCausalLM, input_ids: Sequence[int],
                         cfg: PromptLookupConfig) -> List[int]:
    """Greedy decode with prompt-lookup speculation at batch 1, the windows
    driven from the host. Returns the generated ids (an eos included if
    hit), equal to the stepped greedy stream."""
    ids = [int(t) for t in input_ids]
    T, N, G = len(ids), cfg.max_new_tokens, max(2, cfg.gamma)
    dev = model.device
    cur, cache = _prefill(model, ids, T + N + G)
    cur = int(cur)
    out: List[int] = [cur]
    eos = set(cfg.eos_ids)
    kv_len = T
    while len(out) < N and cur not in eos:
        draft = propose(ids + out, G - 1, cfg.max_ngram, cfg.pad_id)
        window = torch.tensor([[cur] + draft], dtype=torch.long, device=dev)
        preds = _verify(model, cache, torch.tensor([kv_len], dtype=torch.int32, device=dev),
                        window).tolist()
        # Commit preds[0]; keep walking while the draft guessed right.
        committed = 0
        for i in range(G):
            t = preds[i]
            out.append(t)
            committed += 1          # window[i] is now a validated position
            if len(out) >= N or t in eos:
                break
            if i + 1 >= G or draft[i] != t:
                break
        # Positions kv_len .. kv_len + committed - 1 of the cache hold the
        # KV of [cur] + the accepted draft; the rest is written again.
        kv_len += committed
        cur = out[-1]
    return out[:N]


def _dynamic_slice(x: torch.Tensor, start: torch.Tensor, size: int) -> torch.Tensor:
    """x[start : start + size] for a 0-d device index, the start clamped to
    [0, len(x) - size] as jax.lax.dynamic_slice clamps it (no host read)."""
    start = start.clamp(0, x.shape[0] - size)
    return x[start + torch.arange(size, device=x.device)]


def propose_dev(buf: torch.Tensor, L: torch.Tensor, n: int, max_ngram: int,
                pad_id: int) -> torch.Tensor:
    """``propose`` on the device: buf [MAXLEN] int32 holds the sequence in
    its first L positions (L a 0-d device tensor). The longest k-gram suffix
    with an earlier occurrence wins, its latest occurrence; the
    continuation's positions at or past L read pad_id. [n] int32."""
    MAXLEN = buf.shape[0]
    pad = torch.full((), pad_id, dtype=buf.dtype, device=buf.device)
    draft = torch.full((n,), pad_id, dtype=buf.dtype, device=buf.device)
    # Shortest k first, so the longest k that matched is written last.
    for k in range(1, max(1, max_ngram) + 1):
        pat = _dynamic_slice(buf, (L - k).clamp_min(0), k)
        eq = torch.ones((MAXLEN - k,), dtype=torch.bool, device=buf.device)
        for j in range(k):
            eq = eq & (buf[j:MAXLEN - k + j] == pat[j])
        # s must leave at least one continuation token inside the prefix
        s_idx = torch.arange(MAXLEN - k, dtype=torch.int32, device=buf.device)
        cand = eq & (s_idx <= L - k - 1)
        s_star = torch.where(cand, s_idx, torch.full_like(s_idx, -1)).max()
        found = (s_star >= 0) & (L - 1 >= k)
        start = s_star.clamp_min(0) + k
        cont = _dynamic_slice(buf, start, n)
        pos = start + torch.arange(n, dtype=torch.int32, device=buf.device)
        draft = torch.where(found, torch.where(pos < L, cont, pad), draft)
    return draft


@torch.inference_mode()
def speculative_generate_ondevice(model: LlamaForCausalLM, input_ids: Sequence[int],
                                  cfg: PromptLookupConfig,
                                  oracle: Optional[Sequence[int]] = None,
                                  corrupt_every: int = 0) -> List[int]:
    """``speculative_generate`` with the propose, verify, accept and commit
    of every window as tensor operations on the model's device; the host
    reads one flag a window (done) and the buffer at the end. Commits the
    same stream as the host loop.

    oracle / corrupt_every: an instrument for the tok/s-against-acceptance
    curve. Given `oracle` (a token stream, such as an earlier greedy output
    of the same prompt), the drafts come from it instead of the n-gram
    table; ``corrupt_every=k`` adds 1 to every k-th oracle token, so
    acceptance is dialled between about 100% (k = 0) and about one token a
    window. Verification is unchanged, so the committed stream is the
    model's greedy stream for any draft source."""
    ids = [int(t) for t in input_ids]
    T, N, G = len(ids), cfg.max_new_tokens, max(2, cfg.gamma)
    MAXLEN = T + N + G
    dev = model.device
    i32 = dict(dtype=torch.int32, device=dev)
    eos = torch.tensor(list(cfg.eos_ids) or [-1], **i32)
    orc = None
    if oracle is not None:
        orc = torch.full((MAXLEN,), cfg.pad_id, **i32)
        src = list(oracle)[:MAXLEN]
        orc[:len(src)] = torch.tensor(src, **i32)
        if corrupt_every:
            idx = torch.arange(MAXLEN, **i32)
            orc = torch.where(idx % corrupt_every == corrupt_every - 1, orc + 1, orc)

    cur, cache = _prefill(model, ids, MAXLEN)
    buf = torch.zeros((MAXLEN,), **i32)
    buf[:T] = torch.tensor(ids, **i32)
    buf[T] = cur
    out_len = torch.ones((), **i32)
    steps = torch.arange(G, **i32)
    done = (out_len >= N) | (cur == eos).any()
    while not bool(done):
        L = T + out_len
        kv_len = L - 1                          # cur's KV is still to be written
        if orc is not None:
            # out_len tokens are committed; the draft continues the oracle
            # stream after the last committed position.
            draft = _dynamic_slice(orc, out_len, G - 1)
        else:
            draft = propose_dev(buf, L, G - 1, cfg.max_ngram, cfg.pad_id)
        window = torch.cat([cur[None], draft])[None].long()                  # [1, G]
        preds = _verify(model, cache, kv_len[None], window)                 # [G]
        is_eos = (preds[:, None] == eos[None]).any(-1)
        ok = (draft == preds[:-1]) & ~is_eos[:-1]
        c = (1 + torch.cumprod(ok.to(torch.int32), 0).sum()).clamp_max(N - out_len)
        buf[(L.clamp(0, MAXLEN - G) + steps).long()] = preds
        cur = preds.index_select(0, (c - 1).long().reshape(1)).reshape(())
        out_len = out_len + c
        done = (out_len >= N) | (cur == eos).any()
    n = int(out_len)
    return buf[T:T + n].tolist()
