"""Observability (counterpart of spider_tpu/common/observability.py):
metrics.jsonl -> TensorBoard export, and a per-component device-memory
budget.

The runner writes a metrics.jsonl stream (``RunnerBase.train_epoch``); this
module converts it to TensorBoard event files after (or during) a run, and
reports what resident components hold on the card, so multi-model residency
(the LLM and several decoders) is visible before it runs out of memory.
"""

from __future__ import annotations

import json
import logging
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn


def export_tensorboard(metrics_jsonl: str, logdir: str) -> int:
    """Write every scalar in a metrics.jsonl stream into TensorBoard event
    files. Returns the number of steps exported."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except Exception as e:  # torch TB not available: fail loudly, not silently
        raise RuntimeError(f"TensorBoard writer unavailable: {e}")

    writer = SummaryWriter(logdir)
    n = 0
    with open(metrics_jsonl) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            step = int(rec.get("step", n))
            for key, val in rec.items():
                if key in ("step", "epoch"):
                    continue
                try:
                    writer.add_scalar(key, float(val), step)
                except (TypeError, ValueError):
                    pass
            n += 1
    writer.close()
    return n


def tree_bytes(tree) -> int:
    """Bytes held by a tensor, an ``nn.Module`` (its parameters and buffers,
    each counted once) or nested dicts, lists and tuples of them and of numpy
    arrays; any other leaf counts as one float32, as in the JAX package."""
    if isinstance(tree, nn.Module):
        seen = {}
        for t in list(tree.parameters()) + list(tree.buffers()):
            seen[id(t)] = t
        return sum(t.numel() * t.element_size() for t in seen.values())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if tree is None:
        return 0
    return int(np.size(tree)) * np.dtype(getattr(tree, "dtype", np.float32)).itemsize


class HbmBudget:
    """Registry of resident components and their parameter footprints on
    one device.

    Usage at serving startup:
        budget = HbmBudget(torch.device("cuda", 0))
        budget.register("llm(int8)", llm)
        budget.register("sd15", pipe.unet)
        budget.report()
    """

    def __init__(self, device):
        self.device = torch.device(device)
        self.components: Dict[str, int] = {}

    def register(self, name: str, tree) -> "HbmBudget":
        self.components[name] = tree_bytes(tree)
        return self

    def device_stats(self) -> Optional[Dict[str, Any]]:
        """{bytes_in_use, bytes_limit, bytes_free} of the CUDA device, or
        None on the CPU."""
        if self.device.type != "cuda":
            return None
        free, total = torch.cuda.mem_get_info(self.device)
        return {"bytes_in_use": torch.cuda.memory_allocated(self.device),
                "bytes_limit": total, "bytes_free": free}

    def report(self, log=logging.info) -> Dict[str, Any]:
        total = sum(self.components.values())
        rows = {k: round(v / 1e9, 3) for k, v in
                sorted(self.components.items(), key=lambda kv: -kv[1])}
        stats = self.device_stats() or {}
        out = {
            "components_gb": rows,
            "registered_total_gb": round(total / 1e9, 3),
            "hbm_in_use_gb": round(stats.get("bytes_in_use", 0) / 1e9, 3),
            "hbm_limit_gb": round(stats.get("bytes_limit", 0) / 1e9, 3),
        }
        log("HBM budget: %s", json.dumps(out))
        return out
