"""PrefetchLoader on a CUDA device: batches copied from pinned host memory
on its side stream equal, bit for bit, ``prepare_sample`` of the same
batches, while the consumer writes into each batch it holds with the next
batch's copy in flight (the consumer's stream waits for a batch's copy; the
batch's memory is not handed to a later copy while the consumer's work on it
is queued).

It needs an NVIDIA GPU and skips without one. It imports torch only:
``python -m pytest --noconftest tests/test_torch_loaders_cuda.py``.
"""

import numpy as np
import pytest
import torch

from spider_tpu_torch.datasets.utils.loaders import PrefetchLoader, prepare_sample

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: PrefetchLoader's CUDA path copies on a CUDA stream")
    return torch.device("cuda", 0)


def _batches(n, seed=0, big=(4, 3, 2, 224, 224)):
    rng = np.random.default_rng(seed)
    for i in range(n):
        yield {"Question": [f"q{i}"] * 4, "IMAGE": [rng.standard_normal(big).astype(np.float32)],
               "MASK": [(rng.random((4, 256, 256)) > 0.5).astype(np.float32)],
               "ids": rng.integers(0, 1 << 40, (4, 512)), "Meta_info": {"box": [np.ones(4)]}}


def _flat(batch):
    return [batch["IMAGE"][0], batch["MASK"][0], batch["ids"], batch["Meta_info"]["box"][0]]


@pytest.mark.parametrize("depth", [1, 3])
def test_prefetched_batches_equal_prepare_sample_while_the_consumer_writes(dev, depth):
    want = [[t.clone() for t in _flat(prepare_sample(b, dev))] for b in _batches(8)]
    got = []
    for batch in PrefetchLoader(_batches(8), depth, dev):
        tensors = _flat(batch)
        assert all(t.device == dev for t in tensors) and batch["Question"][0].startswith("q")
        got.append([t.clone() for t in tensors])
        # long work on the consumer's stream, writing into the batch it holds,
        # while the worker's next copies run on the side stream
        x = tensors[0]
        for _ in range(20):
            x.mul_(1.0001).add_(1.0)
        tensors[2].zero_()
    torch.cuda.synchronize()
    assert len(got) == 8
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_prefetched_batch_memory_is_not_reused_under_queued_work(dev):
    """Each batch is freed right after a long queued read of it; had the
    allocator handed its block to the next copy, the sums would see the next
    batch's values."""
    sums, want = [], []
    for i, batch in enumerate(PrefetchLoader(_batches(6, seed=1), 2, dev)):
        x = batch["IMAGE"][0]
        y = x
        for _ in range(30):
            y = y * 1.0
        sums.append(y.double().sum())
        del batch, x, y
    want = [torch.from_numpy(b["IMAGE"][0]).double().sum() for b in _batches(6, seed=1)]
    torch.cuda.synchronize()
    for s, w in zip(sums, want):
        assert float(s) == pytest.approx(float(w), rel=1e-9)
