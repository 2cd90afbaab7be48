"""Plain Qwen2.5-Omni web chat of the port, no Spider decoders (twin of the
root qwen2.5omni_web.py): text, audio, image and video understanding in,
text and speech out, over the stdlib HTTP server (serving/http_server.py).

    python -m spider_tpu_torch.qwen2_5omni_web [--port 7860] [--device cuda|cpu]

Backbones, in the reference's order:
  * ``OMNI_CKPT`` set: the transformers adapter
    (``qwen2_5omni_infer.build_omni_chat_fn``), text only;
  * otherwise the port's speech pipeline (models/omni_speech.py, tiny and
    random), whose waveform follows the text as an ``audio`` event of the
    stream.
Runs on cuda:0 unless the caller asks for the CPU.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np


class OmniSpeechChat:
    """A SpiderFree chat function with a speech side channel: the last
    reply's waveform stays in ``last_wav`` for the stream to append."""

    def __init__(self, *, device="cuda"):
        from spider_tpu_torch.models.omni_speech import build_tiny_omni_speech

        self.pipe = build_tiny_omni_speech(device=device)
        self.last_wav: Optional[np.ndarray] = None

    def __call__(self, prompt: str, audios=None, images=None, videos=None) -> str:
        text, wav = self.pipe.chat_with_speech(prompt, audios=audios, images=images,
                                               videos=videos)
        self.last_wav = wav
        return text


def main(argv=None, background: bool = False):
    """Serve until interrupted; with background=True start the server on a
    daemon thread and return it (``server.server_address`` has the port)."""
    from spider_tpu_torch.common.config import Config
    from spider_tpu_torch.common.utils import resolve_device
    from spider_tpu_torch.serving.http_server import serve
    from spider_tpu_torch.serving.spider_free import SpiderFree

    parser = argparse.ArgumentParser(description="Omni web chat with speech (PyTorch port)")
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    device = resolve_device(args.device, "qwen2_5omni_web")

    qwen_path = os.environ.get("OMNI_CKPT")
    speech = None
    if qwen_path:
        from spider_tpu_torch.qwen2_5omni_infer import build_omni_chat_fn

        chat_fn = build_omni_chat_fn(qwen_path, device=device)
    else:
        speech = OmniSpeechChat(device=device)
        chat_fn = speech
    cfg = Config.fromdict({"model": {"type": "spider_decoder", "system_prompt": ""}})
    sf = SpiderFree(cfg, chat_fn, decoders={})
    if speech is not None:
        inner = sf.chat_stream

        def chat_stream(*a, **kw):
            # the talker's waveform follows the text as an audio event
            speech.last_wav = None
            yield from inner(*a, **kw)
            if speech.last_wav is not None and speech.last_wav.size:
                yield "audio", dict(media=speech.last_wav, caption="(speech reply)")

        sf.chat_stream = chat_stream
    return serve(sf, host=args.host, port=args.port, background=background)


if __name__ == "__main__":
    main()
