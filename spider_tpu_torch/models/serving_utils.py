"""Serving-side model loading (counterpart of spider_tpu/models/serving_utils.py)."""

from __future__ import annotations

import logging
import os
from typing import Optional


def load_or_init_llm(ckpt_path: Optional[str] = None, tiny: Optional[bool] = None, *,
                     device="cuda"):
    """(model, tokenizer) on `device`. With a checkpoint directory: the real
    DeepSeek-R1-Distill-Llama-8B weights, unquantised as the reference
    converts them, and its HF tokenizer (``load_tokenizer``, which needs
    ``transformers``). Otherwise: random from seed 0, llama_tiny (the
    default) or the 8B, with TinyTokenizer. A `ckpt_path` that is not a
    directory raises, where the reference would fall back to random
    weights."""
    from spider_tpu_torch.models import llama as L
    from spider_tpu_torch.models.convert import convert_llama_checkpoint
    from spider_tpu_torch.models.factory import build_llama
    from spider_tpu_torch.models.tokenizer import TinyTokenizer, load_tokenizer

    if ckpt_path:
        if not os.path.isdir(ckpt_path):
            raise FileNotFoundError(f"{ckpt_path}: not a checkpoint directory")
        _, model = convert_llama_checkpoint(ckpt_path, device=device)
        return model, load_tokenizer(ckpt_path)
    if tiny is None:
        tiny = True
    cfg = L.llama_tiny(vocab_size=512) if tiny else L.llama3_8b()
    logging.warning("no checkpoint provided: random-init %s", "tiny" if tiny else "8B")
    return build_llama(cfg, device).eval(), TinyTokenizer()
