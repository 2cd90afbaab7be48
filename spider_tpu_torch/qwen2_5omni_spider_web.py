"""SpiderFree web demo of the port (twin of the root
qwen2.5omni_spider_web.py): the chat backbone that qwen2_5omni_infer
selects, the tag-grammar system prompt and the Decoders-Controller with the
tiny decoders of the spider_decoder_infer twin, behind the stdlib HTTP chat
page.

    python -m spider_tpu_torch.qwen2_5omni_spider_web [--port 7860] [--device cuda|cpu]

Runs on cuda:0 unless the caller asks for the CPU.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None, background: bool = False):
    """Serve until interrupted; with background=True start the server on a
    daemon thread and return it."""
    from spider_tpu_torch.common.config import Config
    from spider_tpu_torch.common.utils import resolve_device
    from spider_tpu_torch.qwen2_5omni_infer import build_chat_fn
    from spider_tpu_torch.serving.http_server import serve
    from spider_tpu_torch.serving.spider_free import SpiderFree
    from spider_tpu_torch.spider_decoder_infer import build_default_decoders

    parser = argparse.ArgumentParser(description="SpiderFree web demo (PyTorch port)")
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    device = resolve_device(args.device, "qwen2_5omni_spider_web")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = Config.fromfile(os.path.join(root, "train_configs", "spider_decoder_cfg.py"))
    sf = SpiderFree(cfg, build_chat_fn(device=device),
                    decoders=build_default_decoders(device=device))
    return serve(sf, host=args.host, port=args.port, background=background)


if __name__ == "__main__":
    main()
