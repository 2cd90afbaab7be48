"""Web chat of the port for the DeepSeek-R1-Distill-Llama-8B-class decoder
(twin of the root r1_llama3_8B_gradio.py): the stdlib HTTP server
(serving/http_server.py) with no task decoders attached, text in and text
out, streamed over SSE, the chat through prompt-lookup speculation.

    python -m spider_tpu_torch.r1_llama3_8B_gradio [--port 6006] [--device cuda|cpu]

Real weights: SPIDER_TPU_LLM_CKPT=/path/to/hf_dir (converted on load). Runs on
cuda:0 unless the caller asks for the CPU.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None, background: bool = False):
    """Serve until interrupted; with background=True start the server on a
    daemon thread and return it (``server.server_address`` has the port)."""
    from spider_tpu_torch.common.config import Config
    from spider_tpu_torch.common.utils import resolve_device
    from spider_tpu_torch.models.serving_utils import load_or_init_llm
    from spider_tpu_torch.serving.http_server import serve
    from spider_tpu_torch.serving.spider_free import SpiderFree, make_llama_chat_fn

    parser = argparse.ArgumentParser(description="web chat (PyTorch port)")
    parser.add_argument("--port", type=int, default=6006)  # the reference's port
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--max-new-tokens", type=int, default=512)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    device = resolve_device(args.device, "r1_llama3_8B_gradio")

    model, tokenizer = load_or_init_llm(os.environ.get("SPIDER_TPU_LLM_CKPT"), device=device)
    chat_fn = make_llama_chat_fn(model, tokenizer, max_new_tokens=args.max_new_tokens,
                                 speculative=True)
    # a plain chatbot: no decoders, no tag system prompt
    cfg = Config.fromdict({"model": {"type": "spider_decoder", "system_prompt": ""}})
    sf = SpiderFree(cfg, chat_fn, decoders={})
    return serve(sf, host=args.host, port=args.port, background=background)


if __name__ == "__main__":
    main()
