"""Loader utilities (counterpart of spider_tpu/datasets/utils/loaders.py).

  * MultiIterLoader: ratio-weighted mixing of multiple sources, every draw
    from one seeded RNG stream, so the choice is reproducible.
  * IterLoader: epoch-aware infinite iterator.
  * ChainDataset: sample-ratio chaining of iterable datasets.
  * batched / collate_samples: sample dicts -> batch dicts.
  * prepare_sample: numpy leaves -> tensors on an explicit device.
  * PrefetchLoader: a worker thread stays `depth` batches ahead; on a CUDA
    device it copies from pinned host memory on a side stream, and the
    consumer's stream waits for a batch's copy before it is handed out.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch


class MultiIterLoader:
    """Draw each batch from one of `loaders`, picked with probability
    proportional to `ratios` from a deterministic shared RNG."""

    def __init__(self, loaders: Sequence[Iterable],
                 ratios: Optional[Sequence[float]] = None, seed: int = 42):
        if not loaders:
            raise ValueError("MultiIterLoader needs at least one loader")
        if ratios is None:
            ratios = [1.0] * len(loaders)
        ratios = np.asarray(ratios, np.float64)
        self._p = ratios / ratios.sum()
        self._iters = [iter(l) for l in loaders]
        self._rng = np.random.default_rng(seed)

    def __iter__(self):
        return self

    def __next__(self):
        idx = int(self._rng.choice(len(self._iters), p=self._p))
        return next(self._iters[idx])


class IterLoader:
    """Infinite iterator with epoch tracking: restarts `loader` (calling its
    ``set_epoch`` where it has one) each time it runs out."""

    def __init__(self, loader: Iterable, use_distributed: bool = False):
        self._loader = loader
        self._epoch = 0
        self._iter = iter(loader)

    @property
    def epoch(self) -> int:
        return self._epoch

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self._iter)
        except StopIteration:
            self._epoch += 1
            if hasattr(self._loader, "set_epoch"):
                self._loader.set_epoch(self._epoch)
            self._iter = iter(self._loader)
            return next(self._iter)


class ChainDataset:
    """Chain iterable datasets with per-source sample ratios."""

    def __init__(self, datasets: Sequence[Iterable],
                 ratios: Optional[Sequence[float]] = None, seed: int = 0):
        self.loader = MultiIterLoader(datasets, ratios, seed)

    def __iter__(self):
        return iter(self.loader)


def collate_samples(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    """List of sample dicts -> batch dict: every value becomes a list (arrays
    stay separate arrays; ``Spider.prepare_batch`` stacks them)."""
    if not samples:
        raise ValueError("no samples to collate")
    out: Dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[key] = [np.asarray(v) for v in vals]
        else:
            out[key] = vals
    return out


def batched(loader: Iterable[Dict], batch_size: int) -> Iterator[Dict]:
    buf: List[Dict] = []
    for sample in loader:
        buf.append(sample)
        if len(buf) == batch_size:
            yield collate_samples(buf)
            buf = []


def _map_arrays(tree, fn):
    """`fn` on every numpy array leaf (object arrays excepted) of nested
    dicts, lists and tuples; every other leaf kept."""
    if isinstance(tree, dict):
        return {k: _map_arrays(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_arrays(v, fn) for v in tree)
    if isinstance(tree, np.ndarray) and tree.dtype != object:
        return fn(tree)
    return tree


def _tensors(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:       # torch.from_numpy shares memory: never a read-only one
        a = a.copy()
    return torch.from_numpy(a)


def prepare_sample(sample: Dict[str, Any], device) -> Dict[str, Any]:
    """Every numpy array of `sample` (nested dicts, lists and tuples) as a
    tensor of its dtype on `device`; strings and other leaves unchanged."""
    device = torch.device(device)
    return _map_arrays(sample, lambda a: _host_tensor(a).to(device))


class _Failure:
    def __init__(self, error: BaseException):
        self.error = error


class PrefetchLoader:
    """Wraps an iterable of batches; a worker thread stays `depth` batches
    ahead and moves their arrays to `device` (as ``prepare_sample`` does).

    On a CUDA device the worker copies each array from pinned host memory
    with a non-blocking copy on its own stream and records an event after
    the batch's copies. Before a batch is handed out, the consumer's current
    stream waits on that event, and every tensor of the batch is marked with
    ``record_stream`` for it, so the caching allocator does not give the
    memory to a later copy while the consumer's work on it is queued. On
    the CPU it is a plain threaded queue. An error in the wrapped loader is
    raised in the consumer."""

    _DONE = object()

    def __init__(self, loader: Iterable, depth: int, device):
        if depth < 1:
            raise ValueError("PrefetchLoader needs depth >= 1")
        self.loader = loader
        self.depth = depth
        self.device = torch.device(device)

    def __iter__(self) -> Iterator[Any]:
        device = self.device
        cuda = device.type == "cuda"
        side = torch.cuda.Stream(device=device) if cuda else None
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def copy_cuda(sample):
            with torch.cuda.device(device), torch.cuda.stream(side):
                moved = _map_arrays(
                    sample,
                    lambda a: _host_tensor(a).pin_memory().to(device, non_blocking=True))
                ready = torch.cuda.Event()
                ready.record(side)
            return moved, ready

        def worker():
            try:
                for sample in self.loader:
                    item = copy_cuda(sample) if cuda else (prepare_sample(sample, device), None)
                    if not put(item):
                        return
            except Exception as e:  # handed to the consumer, raised there
                put(_Failure(e))
                return
            put(self._DONE)

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is self._DONE:
                    break
                if isinstance(item, _Failure):
                    raise item.error
                batch, ready = item
                if ready is not None:
                    consumer = torch.cuda.current_stream(device)
                    consumer.wait_event(ready)
                    for t in _tensors(batch):
                        t.record_stream(consumer)
                yield batch
        finally:
            stop.set()
            thread.join()
