"""Continuous-batching LLM server (counterpart of
spider_tpu/serving/continuous.py): a fixed pool of KV-cache slots decodes a
chunk of tokens per tick for every active request; new requests prefill into
free slots and join the next tick without disturbing in-flight ones.

``ContinuousBatcher`` gives every slot a contiguous cache of ``max_len``
rows. ``PagedContinuousBatcher`` keeps one pool of ``page``-row blocks that
slots map through a host-managed page table, so mixed prompt lengths share
the pool instead of each pinning ``max_len``; its decode step runs the
paged decode kernel (ops/paged_attention.py).

What changes from the reference, and why:
  * The ``lax.scan`` chunk is a Python loop of ``decode_steps`` single-token
    steps on static shapes, as models/decode.py does; the prefill splice and
    the page writes are in-place copies into the cache or pool.
  * Admission stays asynchronous: the first token of a prefill stays on the
    device until the tick's one host sync, behind the decode chunk.
  * The serving thread runs every tick under ``torch.inference_mode()``
    (it is thread-local, so the thread enters it itself).
  * A request that finishes while its first token is still pending (a
    resumed request with one token of budget left) takes that token first,
    so its text is whole and no stale pending entry stays behind; the
    reference finishes it one token short (continuous.py:191-197,265-269).

Requests join and finish at chunk boundaries: tokens decoded past a
request's eos or budget are discarded on the host, so every output equals
a greedy ``generate`` of the same prompt.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from spider_tpu_torch.models.llama import (KVCache, LlamaConfig, LlamaForCausalLM,
                                           init_kv_cache, init_paged_kv_cache)
from spider_tpu_torch.ops.sampling import greedy


@dataclasses.dataclass
class _Request:
    ids: List[int]
    future: Future
    slot: int = -1
    emitted: List[int] = dataclasses.field(default_factory=list)
    # number of emitted tokens already folded into `ids` by preemption, so a
    # twice-preempted request does not count its history twice
    n_consumed: int = 0


class ContinuousBatcher:
    def __init__(self, model: LlamaForCausalLM, tokenizer, num_slots: int = 8,
                 max_len: int = 1024, max_new_tokens: int = 128, prefill_bucket: int = 128,
                 decode_steps: int = 8):
        self.model = model
        self.tokenizer = tokenizer
        self.S = num_slots
        self.max_len = max_len
        self.max_new_tokens = max_new_tokens
        self.prefill_bucket = prefill_bucket
        # Tokens decoded per tick: requests join and finish at chunk
        # boundaries, and the host syncs once per chunk.
        self.decode_steps = decode_steps
        self.device = model.device
        cfg = model.config

        # device state
        self.cache = self._make_cache(cfg, num_slots, max_len)
        self.kv_len = torch.zeros(num_slots, dtype=torch.int32, device=self.device)
        self.last_tok = torch.zeros(num_slots, dtype=torch.int32, device=self.device)
        # host state
        self.active = np.zeros((num_slots,), bool)
        self.budget = np.zeros((num_slots,), np.int64)
        # host mirror of kv_len (set exactly on admission, refreshed at each
        # tick's sync): page planning must not sync the device
        self._kv_len_host = np.zeros((num_slots,), np.int64)
        # (request, first token on the device) pairs awaiting the tick's sync
        self._pending_tok0: List[Tuple[_Request, torch.Tensor]] = []
        # Work dispatched, for checking kernel launch counts: single-token
        # decode steps (decode_steps per tick) and prefills.
        self.n_decode_steps = 0
        self.n_prefills = 0

        self._requests: Dict[int, _Request] = {}
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._deferred: List[_Request] = []   # admission deferred (pool full)
        self._stop = False
        self._dead = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------ API
    def submit(self, prompt: str) -> Future:
        if self._dead:
            raise RuntimeError("batcher serving loop has terminated")
        ids = list(self.tokenizer(prompt, add_special_tokens=True).input_ids)
        fut: Future = Future()
        self._queue.put(_Request(ids=ids, future=fut))
        return fut

    def chat(self, prompt: str, timeout: float = 600.0) -> str:
        return self.submit(prompt).result(timeout)

    def close(self):
        self._stop = True
        self._thread.join(timeout=5)

    # ------------------------------------------------------------ the model
    def _prefill(self, ids: List[int], bucket: int) -> Tuple[KVCache, torch.Tensor]:
        """Prefill `ids`, right-padded to `bucket`, into a fresh one-row cache:
        (cache (k, v) each [L, 1, bucket, Hkv, D], first token [1] int32 on
        the device)."""
        arr = torch.full((1, bucket), self.tokenizer.pad_token_id, dtype=torch.long)
        arr[0, : len(ids)] = torch.tensor(ids, dtype=torch.long)
        small = init_kv_cache(self.model.config, 1, bucket, device=self.device)
        positions = torch.arange(bucket, dtype=torch.int32, device=self.device)[None]
        plen = torch.tensor([len(ids)], dtype=torch.int32, device=self.device)
        logits, _, small = self.model(input_ids=arr.to(self.device), positions=positions,
                                      kv_write_index=0, kv_cache=small, kv_len=plen)
        self.n_prefills += 1
        return small, greedy(logits[:, max(len(ids) - 1, 0)])

    def _decode_chunk(self, active_mask: torch.Tensor,
                      page_table: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`decode_steps` single-token steps for every slot -> tokens
        [S, decode_steps]. Slots that emit eos mid-chunk go dead (emit pad,
        kv_len frozen); their stale-position writes are never attended
        after reuse (prefill re-splices from 0, attention masks by kv_len)."""
        pad = self.tokenizer.pad_token_id
        eos = self.tokenizer.eos_token_id
        kv_len, last_tok, alive = self.kv_len, self.last_tok, active_mask
        toks = []
        for _ in range(self.decode_steps):
            emb = self.model.embed(last_tok[:, None].long())
            logits, _, _ = self.model(inputs_embeds=emb, positions=kv_len[:, None],
                                      kv_write_index=kv_len, kv_cache=self.cache,
                                      kv_len=kv_len + 1, page_table=page_table)
            nxt = torch.where(alive, greedy(logits[:, -1]), pad)
            kv_len = kv_len + alive.to(kv_len.dtype)
            last_tok = torch.where(alive, nxt, last_tok)
            alive = alive & (nxt != eos)
            toks.append(nxt)
        self.kv_len, self.last_tok = kv_len, last_tok
        self.n_decode_steps += self.decode_steps
        return torch.stack(toks, dim=1)

    # ------------------------------------------------------------ admission
    def _bucket(self, n: int) -> int:
        return -(-n // self.prefill_bucket) * self.prefill_bucket

    def _remaining(self, req: _Request) -> int:
        # budget left for a (possibly preempted-and-resumed) request; its
        # earlier emissions are part of req.ids by the time it is re-admitted
        return self.max_new_tokens - len(req.emitted)

    def _admit(self, req: _Request, slot: int):
        ids = req.ids[: self.max_len - self._remaining(req)]
        bucket = self._bucket(len(ids))
        small, tok0 = self._prefill(ids, bucket)
        rows = min(bucket, self.max_len)
        for cache, new in zip(self.cache, small):
            cache[:, slot, :rows] = new[:, 0, :rows]
        self._start(req, slot, len(ids), tok0)

    def _start(self, req: _Request, slot: int, n_ids: int, tok0: torch.Tensor):
        self.kv_len[slot] = n_ids
        self._kv_len_host[slot] = n_ids
        self.last_tok[slot] = tok0[0]       # stays on the device
        self.active[slot] = True
        req.slot = slot
        self._pending_tok0.append((req, tok0))   # resolved at the tick sync
        self.budget[slot] = self._remaining(req) - 1   # -1: the pending tok0
        self._requests[slot] = req

    def _finish(self, slot: int):
        req = self._requests.pop(slot)
        self.active[slot] = False
        # A resumed request with one token of budget left finishes before the
        # tick's sync: take its pending first token now.
        mine = [tok for r, tok in self._pending_tok0 if r is req]
        if mine:
            self._pending_tok0 = [(r, t) for r, t in self._pending_tok0 if r is not req]
            req.emitted.append(int(mine[0][0]))
        text = self.tokenizer.decode(
            [t for t in req.emitted if t != self.tokenizer.pad_token_id],
            skip_special_tokens=True)
        req.future.set_result(text)

    def _fail(self, req: _Request):
        req.future.set_exception(RuntimeError(
            f"request can never fit in the paged KV pool ({len(req.ids)} prompt tokens)"))

    # ----------------------------------------------------------------- loop
    def _loop(self):
        try:
            while not self._stop:
                self._tick()
        except Exception as exc:  # fail every pending future, do not hang them
            self._dead = True
            pending = list(self._requests.values()) + self._deferred
            while True:
                try:
                    pending.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            for req in pending:
                if not req.future.done():
                    req.future.set_exception(exc)

    @torch.inference_mode()
    def _tick(self):
        eos = self.tokenizer.eos_token_id
        # admit deferred-then-new requests into free slots; stop at the first
        # request the pool cannot hold yet
        while not all(self.active):
            if self._deferred:
                req = self._deferred[0]
                if not self._feasible(req):
                    self._deferred.pop(0)
                    self._fail(req)
                    continue
                if not self._can_admit(req):
                    break
                self._deferred.pop(0)
            else:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    break
                if not self._feasible(req):
                    self._fail(req)
                    continue
                if not self._can_admit(req):
                    self._deferred.append(req)
                    break
            self._admit(req, int(np.argmin(self.active)))
        if not self.active.any():
            if self._deferred:
                # nothing runs, so every pool page is free: a head request
                # that still cannot be admitted never will be
                req = self._deferred[0]
                if not self._can_admit(req) or not self._feasible(req):
                    self._deferred.pop(0)
                    self._fail(req)
            else:
                try:
                    self._deferred.append(self._queue.get(timeout=0.05))
                except queue.Empty:
                    pass
            return
        # finishes come BEFORE the step (the first token may be eos already)
        for slot in np.where(self.active)[0]:
            req = self._requests[slot]
            if req.emitted and (req.emitted[-1] == eos or self.budget[slot] <= 0):
                self._finish(slot)
        if not self.active.any():
            return
        self._pre_step()
        if not self.active.any():   # _pre_step may preempt every slot
            return
        mask = torch.from_numpy(self.active.copy()).to(self.device)
        toks = self._step(mask).cpu().numpy()          # [S, decode_steps]: the sync
        # first tokens of this tick's admissions precede the chunk's tokens
        if self._pending_tok0:
            vals = torch.cat([t for _, t in self._pending_tok0]).tolist()
            for (req, _), v in zip(self._pending_tok0, vals):
                req.emitted.append(int(v))
            self._pending_tok0.clear()
        self._kv_len_host = self.kv_len.cpu().numpy().astype(np.int64)
        for slot in np.where(self.active)[0]:
            req = self._requests[slot]
            if req.emitted and req.emitted[-1] == eos:
                continue   # the first token was eos; the chunk is over-decode
            for t in toks[slot]:
                if self.budget[slot] <= 0:
                    break                              # over-decode, discarded
                req.emitted.append(int(t))
                self.budget[slot] -= 1
                if int(t) == eos:
                    break

    # ------------------------------------------- hooks of the paged batcher
    def _make_cache(self, cfg: LlamaConfig, num_slots: int, max_len: int) -> KVCache:
        return init_kv_cache(cfg, num_slots, max_len, device=self.device)

    def _can_admit(self, req: _Request) -> bool:
        return True

    def _feasible(self, req: _Request) -> bool:
        """Whether the pool can hold this request over its whole lifetime
        (checked on admission, so a slot never has to preempt itself)."""
        return True

    def _pre_step(self):
        pass

    def _step(self, mask: torch.Tensor) -> torch.Tensor:
        return self._decode_chunk(mask)


class PagedContinuousBatcher(ContinuousBatcher):
    """Continuous batcher over a block-paged KV pool: slots map logical pages
    to pool blocks through a host-managed page table, so mixed prompt
    lengths never pin max_len per slot and the same memory holds more
    concurrent sequences.

    num_blocks defaults to num_slots * max_len / page (the contiguous
    batcher's worst case); lower it to oversubscribe. When decode growth
    finds the pool empty, the slot holding the most pages is preempted and
    its request re-prefills later as a continuation."""

    def __init__(self, model: LlamaForCausalLM, tokenizer, num_slots: int = 8,
                 max_len: int = 1024, max_new_tokens: int = 128, prefill_bucket: int = 128,
                 page: int = 128, num_blocks: Optional[int] = None):
        if prefill_bucket % page:
            raise ValueError(f"prefill_bucket={prefill_bucket} must be a multiple of "
                             f"page={page}")
        self.page = page
        self.max_pages = max_len // page
        # +1: block 0 is a scratch block, never allocated. Inactive slots
        # still write every step, and their zeroed table rows route those
        # writes to block 0.
        self._n_blocks = (num_blocks or num_slots * self.max_pages) + 1
        self._free = list(range(1, self._n_blocks))
        self.n_preempts = 0
        self._table = np.zeros((num_slots, self.max_pages), np.int32)
        self._n_alloc = np.zeros((num_slots,), np.int32)
        super().__init__(model, tokenizer, num_slots=num_slots, max_len=max_len,
                         max_new_tokens=max_new_tokens, prefill_bucket=prefill_bucket)

    def _make_cache(self, cfg: LlamaConfig, num_slots: int, max_len: int) -> KVCache:
        return init_paged_kv_cache(cfg, self._n_blocks, self.page, device=self.device)

    def _alloc_page(self, slot: int, logical: int):
        if not self._free:
            raise RuntimeError("paged KV pool exhausted")
        self._table[slot, logical] = self._free.pop()
        self._n_alloc[slot] = logical + 1

    def _release(self, slot: int):
        """Free exactly the pages this slot allocated (on admission and in
        decode growth)."""
        n = int(self._n_alloc[slot])
        self._free.extend(int(b) for b in self._table[slot, :n])
        self._table[slot, :] = 0
        self._n_alloc[slot] = 0

    def _can_admit(self, req: _Request) -> bool:
        ids_len = min(len(req.ids), self.max_len - self._remaining(req))
        return len(self._free) >= -(-max(ids_len, 1) // self.page)

    def _feasible(self, req: _Request) -> bool:
        # lifetime worst case: prompt + full budget (the truncation on
        # admission keeps it <= max_len)
        ids_len = min(len(req.ids), self.max_len - self._remaining(req))
        worst = min(ids_len + self._remaining(req), self.max_len)
        return self._n_blocks - 1 >= -(-max(worst, 1) // self.page)

    def _preempt(self, slot: int):
        """Evict a slot mid-decode: free its pages and requeue its request as
        a continuation prefill (prompt + tokens emitted so far)."""
        self.n_preempts += 1
        req = self._requests.pop(slot)
        # a same-tick admission may still have its first token pending: drop
        # it, the continuation re-prefills the same ids and greedy gives the
        # same token again (the budget is recomputed on admission)
        self._pending_tok0 = [(r, t) for r, t in self._pending_tok0 if r is not req]
        self._release(slot)
        self.active[slot] = False
        req.ids = req.ids + req.emitted[req.n_consumed:]
        req.n_consumed = len(req.emitted)
        self._deferred.append(req)

    def _admit(self, req: _Request, slot: int):
        ids = req.ids[: self.max_len - self._remaining(req)]
        bucket = max(self._bucket(len(ids)), self.page)
        small, tok0 = self._prefill(ids, bucket)
        n_pages = -(-len(ids) // self.page)
        self._table[slot] = 0
        for i in range(n_pages):
            self._alloc_page(slot, i)
        blocks = torch.from_numpy(self._table[slot, :n_pages].astype(np.int64)).to(self.device)
        for pool, new in zip(self.cache, small):
            L, _, _, H, D = new.shape
            rows = new[:, 0, : n_pages * self.page].reshape(L, n_pages, self.page, H, D)
            pool[:, blocks] = rows.to(pool.dtype)
        self._start(req, slot, len(ids), tok0)

    def _finish(self, slot: int):
        self._release(slot)
        super()._finish(slot)

    def _pre_step(self):
        # The coming chunk writes positions kv_len[s] .. kv_len[s] + k - 1,
        # k = min(decode_steps, budget[s]) (writes past the budget are
        # discarded with their tokens): make sure each covering page exists
        # before the dispatch. On exhaustion, preempt the other slot holding
        # the most pages. A slot preempts itself only when infeasible, which
        # admission already rejects.
        lens = self._kv_len_host
        for slot in np.where(self.active)[0]:
            if not self.active[slot]:   # preempted as a victim this tick
                continue
            k = max(1, min(self.decode_steps, int(self.budget[slot])))
            last_logical = min((int(lens[slot]) + k - 1) // self.page, self.max_pages - 1)
            for logical in range(int(self._n_alloc[slot]), last_logical + 1):
                while not self._free:
                    victims = [s for s in np.where(self.active)[0] if s != slot]
                    victim = (max(victims, key=lambda s: self._n_alloc[s]) if victims
                              else slot)
                    self._preempt(int(victim))
                    if victim == slot:
                        break
                if not self.active[slot]:
                    break
                self._alloc_page(slot, logical)

    def _step(self, mask: torch.Tensor) -> torch.Tensor:
        table = torch.from_numpy(self._table.copy()).to(self.device)
        return self._decode_chunk(mask, table)
