"""Interactive chat REPL of the port (twin of the root r1_llama3_8B_chat.py):

    python -m spider_tpu_torch.r1_llama3_8B_chat [--device cuda|cpu]

Each reply streams token by token (``decode.stream_generate``); an empty line
or the end of input ends it. SPIDER_TPU_LLM_CKPT names a checkpoint directory
(``serving_utils.load_or_init_llm``), else the weights are random. Runs on
cuda:0 unless the caller asks for the CPU.
"""

from __future__ import annotations

import argparse
import os

MAX_NEW_TOKENS = 256                  # a reply's length limit, as the root script's


def main(argv=None) -> str:
    """Run the REPL on standard input; returns the conversation's history."""
    import torch

    from spider_tpu_torch.common.utils import resolve_device
    from spider_tpu_torch.models.decode import GenerateConfig, stream_generate
    from spider_tpu_torch.models.serving_utils import load_or_init_llm

    parser = argparse.ArgumentParser(description="streaming chat REPL (PyTorch port)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    device = resolve_device(args.device, "r1_llama3_8B_chat")
    model, tokenizer = load_or_init_llm(os.environ.get("SPIDER_TPU_LLM_CKPT"), device=device)
    gen_cfg = GenerateConfig(max_new_tokens=MAX_NEW_TOKENS,
                             eos_ids=(tokenizer.eos_token_id,), pad_id=tokenizer.pad_token_id)
    history = ""
    print("spider-tpu chat (empty line to exit)")
    while True:
        try:
            user = input("you> ").strip()
        except EOFError:
            break
        if not user:
            break
        history += f"User: {user}\nAssistant:"
        ids = tokenizer(history, add_special_tokens=True).input_ids
        with torch.inference_mode():
            emb = model.embed(torch.tensor([ids], dtype=torch.long, device=device))
        print("bot> ", end="", flush=True)
        reply_ids = []
        for tok in stream_generate(model, emb, torch.tensor([len(ids)], dtype=torch.int32),
                                   gen_cfg):
            reply_ids.append(tok)
            print(tokenizer.decode([tok], skip_special_tokens=True), end="", flush=True)
        print()
        history += tokenizer.decode(reply_ids, skip_special_tokens=True) + "\n"
    return history


if __name__ == "__main__":
    main()
