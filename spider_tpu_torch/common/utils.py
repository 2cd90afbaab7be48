"""Small shared utilities (counterpart of spider_tpu/common/utils.py)."""

from __future__ import annotations

import datetime
import os
from typing import Optional


def now() -> str:
    """Job-id timestamp."""
    return datetime.datetime.now().strftime("%Y%m%d%H%M")[:-1]


def get_cache_path(rel_path: str, cache_root: Optional[str] = None) -> str:
    root = cache_root or os.environ.get(
        "SPIDER_TPU_CACHE", os.path.expanduser("~/.cache/spider_tpu")
    )
    return os.path.join(root, rel_path)


def makedir(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path


def is_url(s: str) -> bool:
    return s.startswith(("http://", "https://"))


def resolve_device(name: str, entry: str):
    """torch.device for an entry script's --device: cuda:0, or the CPU when
    asked for; without a CUDA device 'cuda' exits with a message, never
    running on the CPU."""
    import torch

    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{entry}: no CUDA device; pass --device cpu to run on the CPU")
    return torch.device("cuda", 0) if name == "cuda" else torch.device("cpu")
