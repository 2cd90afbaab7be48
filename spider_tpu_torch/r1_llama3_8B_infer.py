"""Plain text chat entry of the port (twin of the root r1_llama3_8B_infer.py):

    python -m spider_tpu_torch.r1_llama3_8B_infer "Hello" [--device cuda|cpu]

The DeepSeek-R1-Distill-Llama-8B architecture: random weights (llama_tiny)
unless SPIDER_TPU_LLM_CKPT names a checkpoint directory, loaded through
``serving_utils.load_or_init_llm``. Runs on cuda:0 unless the caller asks
for the CPU.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

from spider_tpu_torch.common.utils import resolve_device


def build_r1(tiny: Optional[bool] = None, *, device="cuda"):
    """chat_fn(prompt) -> reply of up to 64 new tokens over the checkpoint
    SPIDER_TPU_LLM_CKPT names, or random weights."""
    from spider_tpu_torch.models.serving_utils import load_or_init_llm
    from spider_tpu_torch.serving.spider_free import make_llama_chat_fn

    model, tokenizer = load_or_init_llm(os.environ.get("SPIDER_TPU_LLM_CKPT"), tiny=tiny,
                                        device=device)
    return make_llama_chat_fn(model, tokenizer, max_new_tokens=64)


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description="one text chat turn (PyTorch port)")
    parser.add_argument("content", nargs="?", default="Hello, who are you?")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    r1 = build_r1(device=resolve_device(args.device, "r1_llama3_8B_infer"))
    reply = r1(args.content)
    print(reply)
    return reply


if __name__ == "__main__":
    main()
