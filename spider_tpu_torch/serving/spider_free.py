"""SpiderFree — the training-free any-to-many stack: a stock instruction LLM
prompted to emit tag grammar, parsed and dispatched by SpiderDecoder
(counterpart of spider_tpu/serving/spider_free.py).

The chat backbone is pluggable: `chat_fn(prompt: str) -> str`. The default
is the port's Llama decoder (DeepSeek-R1-Distill-Llama-8B class) through
``make_llama_chat_fn``; any other model slots in through the same callable.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from spider_tpu_torch.models import tags
from spider_tpu_torch.models.spider_decoder import SpiderDecoderInfer


def build_system_prompt(cfg_model: Dict[str, Any]) -> str:
    """Assemble the SpiderFree system prompt from the decoder config:
    base prompt + per-decoder addenda."""
    parts = [cfg_model.get("system_prompt", "")]
    for key in ("system_prompt_image", "system_prompt_video",
                "system_prompt_audio", "system_prompt_mask",
                "system_prompt_box", "system_prompt_story"):
        addendum = cfg_model.get(key, "")
        if addendum:
            parts.append(addendum)
    return "".join(parts)


def extract_answer(response: str) -> str:
    """Strip reasoning blocks and role scaffolding from a chat response."""
    response = tags.strip_think(response)
    for marker in ("assistant\n", "Assistant:", "ASSISTANT:"):
        if marker in response:
            response = response.split(marker)[-1]
    return response.strip()


class SpiderFree:
    """chat -> parse -> dispatch. Produces per-tag media like the reference's
    streaming loop, returned as a list of (kind, payload) events."""

    def __init__(self, cfg, chat_fn: Callable[[str], str],
                 decoders: Optional[Dict[str, Callable]] = None,
                 story_fn: Optional[Callable] = None):
        self.cfg = cfg
        self.chat_fn = chat_fn
        self.system_prompt = build_system_prompt(dict(cfg.model))
        self.decoder_infer = SpiderDecoderInfer(cfg, decoders=decoders,
                                                story_fn=story_fn)

    # TaskPrompt instructions the reference's modality radio buttons map to:
    # appended to the user turn so the LLM emits the right tags.
    TASK_HINTS = {
        "TEXT": "",
        "IMAGE": " Respond with an image: wrap its caption in "
                 "<IMAGE>...</IMAGE>.",
        "VIDEO": " Respond with a video: wrap its caption in "
                 "<VIDEO>...</VIDEO>.",
        "AUDIO": " Respond with an audio clip: wrap its caption in "
                 "<AUDIO>...</AUDIO>.",
        "MASK": " Segment the requested object: wrap its name in "
                "<MASK>...</MASK>.",
        "BOX": " Detect the requested object: wrap its name in "
               "<BOX>...</BOX>.",
        "SMARTMULTIMODAL": " Choose the best mix of output modalities and "
                           "wrap each caption in its tags.",
        "IMAGESTORY": " Respond with an image story: wrap the story spec in "
                      "<IMAGESTORY>...</IMAGESTORY>.",
    }

    def chat_stream(self, user_text: str,
                    extra_inputs: Optional[Dict[str, Any]] = None,
                    task_prompt: str = "TEXT",
                    audios=None, images=None, videos=None,
                    result: Optional[Dict[str, Any]] = None):
        """Generator of (kind, payload) events. The text event is yielded
        the moment the LLM turn finishes and each media event the moment
        its decoder returns — an 18 s video no longer blocks the image
        that parsed before it (the reference streams per tag the same way).
        Pass `result={}` to receive
        the answers/predictions/predictions_text reference contract after
        the generator is exhausted."""
        from spider_tpu_torch.models.spider_decoder import (empty_predictions,
                                                            empty_predictions_text)

        hint = self.TASK_HINTS.get(task_prompt, "")
        prompt = f"{self.system_prompt}\nUser: {user_text}{hint}\nOutput:"
        if audios or images or videos:
            import inspect

            params = inspect.signature(self.chat_fn).parameters
            if not ({"audios", "images", "videos"} & set(params)
                    or any(p.kind is inspect.Parameter.VAR_KEYWORD
                           for p in params.values())):
                raise ValueError(
                    "chat backbone is text-only but audio/image/video "
                    "understanding inputs were supplied — pass a chat_fn "
                    "that takes them")
            raw = self.chat_fn(prompt, audios=audios, images=images,
                               videos=videos)
        else:
            raw = self.chat_fn(prompt)
        answer = extract_answer(raw)
        predictions = empty_predictions()
        predictions_text = empty_predictions_text()
        if result is not None:
            result["answers"] = [answer]
            result["predictions"] = predictions
            result["predictions_text"] = predictions_text
        yield "text", answer

        ask_info: Dict[str, Any] = dict(extra_inputs or {})
        ask_info["llm_text_all"] = [answer]
        decoder = self.decoder_infer.spider_decoder
        for modality, text_res, preds in decoder.generate_stream(ask_info):
            predictions_text[modality].append(text_res)
            if preds is None:
                continue
            if modality == "BOX":
                predictions["BOX"]["bboxes"].append(preds["outputs_bboxes"][0])
                predictions["BOX"]["label_names"].append(
                    preds["outputs_label_names"][0])
                predictions["BOX"]["scores"].append(preds["outputs_scores"][0])
                yield "box", dict(bboxes=preds["outputs_bboxes"][0],
                                  labels=preds["outputs_label_names"][0],
                                  scores=preds["outputs_scores"][0])
            elif modality in ("IMAGE", "AUDIO", "MASK"):
                predictions[modality].append(preds[0])
                yield modality.lower(), dict(media=preds[0], caption=text_res)
            else:  # VIDEO: whole clip
                predictions[modality].append(preds)
                yield modality.lower(), dict(media=preds, caption=text_res)
        from spider_tpu_torch.models.spider_decoder import run_story_pipeline

        preds = run_story_pipeline(self.decoder_infer.story_fn,
                                   predictions, predictions_text)
        if preds is not None:
            yield "story", dict(images=preds)

    def chat(self, user_text: str,
             extra_inputs: Optional[Dict[str, Any]] = None,
             task_prompt: str = "TEXT",
             audios=None, images=None, videos=None):
        result: Dict[str, Any] = {}
        events: List = list(self.chat_stream(
            user_text, extra_inputs, task_prompt,
            audios=audios, images=images, videos=videos, result=result))
        return (events, result["answers"], result["predictions"],
                result["predictions_text"])


def make_llama_chat_fn(model, tokenizer, max_new_tokens: int = 512,
                       temperature: float = 0.0, generator=None,
                       speculative: bool = False):
    """Default chat backbone: greedy or temperature decode on the port's Llama.
    The prompt's tokens and the decode live on the model's device; sampling
    draws only from `generator`. speculative=True (greedy only) decodes with
    prompt-lookup speculation (models/speculative.py, the on-device loop):
    the greedy stream, several tokens a forward pass where drafts are
    accepted."""
    import torch

    from spider_tpu_torch.models.decode import GenerateConfig, generate

    gen_cfg = GenerateConfig(max_new_tokens=max_new_tokens, temperature=temperature,
                             eos_ids=(tokenizer.eos_token_id,),
                             pad_id=tokenizer.pad_token_id)

    def chat_fn(prompt: str) -> str:
        ids = tokenizer(prompt, add_special_tokens=True).input_ids
        if speculative and temperature <= 0.0:
            from spider_tpu_torch.models.speculative import (PromptLookupConfig,
                                                             speculative_generate_ondevice)

            toks = speculative_generate_ondevice(
                model, ids, PromptLookupConfig(max_new_tokens=max_new_tokens,
                                               eos_ids=(tokenizer.eos_token_id,),
                                               pad_id=tokenizer.pad_token_id))
            toks = [t for t in toks if t != tokenizer.pad_token_id]
            return tokenizer.decode(toks, skip_special_tokens=True)
        arr = torch.tensor([ids], dtype=torch.long, device=model.device)
        with torch.inference_mode():
            embeds = model.embed(arr)
        out = generate(model, embeds, torch.tensor([len(ids)], dtype=torch.int32),
                       gen_cfg, generator=generator)
        toks = [t for t in out["tokens"][0].tolist() if t != tokenizer.pad_token_id]
        return tokenizer.decode(toks, skip_special_tokens=True)

    return chat_fn
