"""Request batcher for LLM serving (counterpart of
spider_tpu/serving/batcher.py): concurrent chat requests are grouped into
waves, each right-padded to a multiple of ``length_bucket`` and decoded by
one ``generate`` call. A worker thread collects a wave (the first request,
then whatever arrives within ``max_wait_s``, up to ``max_batch_size``), runs
it and sets each request's ``concurrent.futures.Future``; an exception in a
wave is set on every future of that wave, and the worker goes on with the
next.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from typing import List, Optional, Tuple

import numpy as np
import torch

from spider_tpu_torch.models.decode import GenerateConfig, generate


class LlmBatcher:
    def __init__(self, model, tokenizer, gen_cfg: Optional[GenerateConfig] = None,
                 max_batch_size: int = 8, max_wait_s: float = 0.02,
                 length_bucket: int = 128):
        self.model = model
        self.tokenizer = tokenizer
        self.gen_cfg = gen_cfg or GenerateConfig(
            max_new_tokens=128, eos_ids=(tokenizer.eos_token_id,),
            pad_id=tokenizer.pad_token_id)
        self.max_batch_size = max_batch_size
        self.max_wait_s = max_wait_s
        self.length_bucket = length_bucket
        self.n_waves = 0
        self._queue: "queue.Queue[Tuple[List[int], Future]]" = queue.Queue()
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------ API
    def submit(self, prompt: str) -> Future:
        ids = list(self.tokenizer(prompt, add_special_tokens=True).input_ids)
        fut: Future = Future()
        self._queue.put((ids, fut))
        return fut

    def chat(self, prompt: str, timeout: float = 600.0) -> str:
        return self.submit(prompt).result(timeout)

    def close(self):
        self._stop = True
        self._queue.put(([], Future()))
        self._thread.join(timeout=5)

    # ---------------------------------------------------------------- worker
    def _collect_wave(self):
        first = self._queue.get()
        if self._stop:
            return []
        wave = [first]
        while len(wave) < self.max_batch_size:
            try:
                item = self._queue.get(timeout=self.max_wait_s)
            except queue.Empty:
                break
            if self._stop:
                break
            wave.append(item)
        return wave

    def pad_wave(self, ids_list: List[List[int]]) -> Tuple[np.ndarray, np.ndarray]:
        """(ids [n, L] right-padded with the pad id, L the longest prompt
        rounded up to length_bucket; true lengths [n] int32)."""
        plen = np.array([len(i) for i in ids_list], np.int32)
        bucket = self.length_bucket
        L = ((int(plen.max()) + bucket - 1) // bucket) * bucket
        arr = np.full((len(ids_list), L), self.tokenizer.pad_token_id, np.int64)
        for i, ids in enumerate(ids_list):
            arr[i, :len(ids)] = ids[:L]
        return arr, np.minimum(plen, L)

    def _run_wave(self, wave):
        arr, plen = self.pad_wave([ids for ids, _ in wave])
        with torch.inference_mode():
            embeds = self.model.embed(torch.from_numpy(arr).to(self.model.device))
        out = generate(self.model, embeds, torch.from_numpy(plen), self.gen_cfg)
        pad = self.tokenizer.pad_token_id
        self.n_waves += 1
        for row, (_, fut) in zip(out["tokens"].tolist(), wave):
            toks = [t for t in row if t != pad]
            fut.set_result(self.tokenizer.decode(toks, skip_special_tokens=True))

    def _loop(self):
        while not self._stop:
            wave = self._collect_wave()
            if not wave:
                continue
            try:
                self._run_wave(wave)
            except Exception as e:      # handed to every caller of the wave
                for _, fut in wave:
                    if not fut.done():
                        fut.set_exception(e)
