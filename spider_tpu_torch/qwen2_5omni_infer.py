"""Qwen2.5-Omni-backed SpiderFree entry of the port (twin of the root
qwen2.5omni_infer.py; the dot of its name becomes ``_``, since ``python -m``
cannot name a module with a dot):

    python -m spider_tpu_torch.qwen2_5omni_infer ["text"] [--device cuda|cpu]

The chat backbone, in the reference's order of preference:
  1. ``QWEN_OMNI_PATH`` names a directory: transformers'
     ``Qwen2_5OmniForConditionalGeneration`` with audio, image and video
     through its processor (``build_omni_chat_fn``; imported only then, and
     not on the path this package measures);
  2. ``SPIDER_TPU_OMNI`` set: the port's Omni thinker (models/qwen_omni.py),
     the full-size model from the checkpoint ``SPIDER_TPU_OMNI_CKPT`` names,
     else the tiny random one;
  3. otherwise the port's Llama as a text-only backbone
     (``SPIDER_TPU_LLM_CKPT``, else random), which refuses audio, image and
     video inputs.
Behind it, SpiderFree with the tiny decoders of the spider_decoder_infer
twin. Runs on cuda:0 unless the caller asks for the CPU.
"""

from __future__ import annotations

import argparse
import os

DEFAULT_TEXT = "Please generate an image and an audio for a running horse."


def build_omni_chat_fn(qwen_path: str, *, device="cuda"):
    """transformers' Qwen2.5-Omni on ``device``: (text, audios, images,
    videos) -> the text answer, as the reference's adapter computes it."""
    import torch
    from transformers import AutoProcessor

    try:
        from transformers import Qwen2_5OmniForConditionalGeneration as _Omni
    except ImportError:  # older transformers naming
        from transformers import Qwen2_5OmniModel as _Omni

    processor = AutoProcessor.from_pretrained(qwen_path)
    model = _Omni.from_pretrained(qwen_path).to(device)

    def chat_fn(prompt: str, audios=None, images=None, videos=None) -> str:
        conversation = [{
            "role": "user",
            "content": ([{"type": "audio", "audio": a} for a in audios or []]
                        + [{"type": "image", "image": i} for i in images or []]
                        + [{"type": "video", "video": v} for v in videos or []]
                        + [{"type": "text", "text": prompt}]),
        }]
        text = processor.apply_chat_template(conversation, tokenize=False,
                                             add_generation_prompt=True)
        inputs = processor(text=text, audio=audios, images=images, videos=videos,
                           return_tensors="pt", padding=True)
        inputs = {k: v.to(device) if torch.is_tensor(v) else v for k, v in inputs.items()}
        out = model.generate(**inputs, max_new_tokens=512)
        gen = out[:, inputs["input_ids"].shape[1]:]     # the echoed prompt cut by count
        return processor.batch_decode(gen, skip_special_tokens=True)[0]

    return chat_fn


def build_chat_fn(*, device="cuda"):
    """The chat backbone the environment selects (see the module docstring)."""
    qwen_path = os.environ.get("QWEN_OMNI_PATH")
    if qwen_path and os.path.isdir(qwen_path):
        return build_omni_chat_fn(qwen_path, device=device)
    if os.environ.get("SPIDER_TPU_OMNI", ""):
        from spider_tpu_torch.models.qwen_omni import build_omni_thinker_chat_fn

        return build_omni_thinker_chat_fn(os.environ.get("SPIDER_TPU_OMNI_CKPT"), device=device)

    from spider_tpu_torch.models.serving_utils import load_or_init_llm
    from spider_tpu_torch.serving.spider_free import make_llama_chat_fn

    model, tokenizer = load_or_init_llm(os.environ.get("SPIDER_TPU_LLM_CKPT"), device=device)
    text_fn = make_llama_chat_fn(model, tokenizer, max_new_tokens=128)

    def chat_fn(prompt: str, audios=None, images=None, videos=None) -> str:
        if audios or images or videos:
            raise ValueError(
                "text-only Llama backbone cannot consume audio/image/video inputs — set "
                "QWEN_OMNI_PATH (torch Omni) or SPIDER_TPU_OMNI=1 (the port's Omni thinker) "
                "for multimodal understanding")
        return text_fn(prompt)

    return chat_fn


def main(argv=None) -> str:
    from spider_tpu_torch.common.config import Config
    from spider_tpu_torch.common.utils import resolve_device
    from spider_tpu_torch.serving.spider_free import SpiderFree
    from spider_tpu_torch.spider_decoder_infer import build_default_decoders

    parser = argparse.ArgumentParser(description="SpiderFree on the Omni chat backbone "
                                                 "(PyTorch port)")
    parser.add_argument("text", nargs="?", default=DEFAULT_TEXT)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    device = resolve_device(args.device, "qwen2_5omni_infer")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = Config.fromfile(os.path.join(root, "train_configs", "spider_decoder_cfg.py"))
    sf = SpiderFree(cfg, build_chat_fn(device=device),
                    decoders=build_default_decoders(device=device))
    events, answers, _, _ = sf.chat(args.text)
    answer = answers[0] if answers else ""
    print("answer:", answer)
    for kind, _ in events:
        if kind != "text":
            print("event:", kind)
    return answer


if __name__ == "__main__":
    main()
