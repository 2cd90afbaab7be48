"""SpiderDecoder — the training-free Decoders-Controller.

Parses ``<X>caption</X>`` tags out of LLM text and routes each caption to the
matching task decoder, accumulating the reference's prediction structure. A
copy of spider_tpu/models/spider_decoder.py: decoders are plain callables, so
the controller is framework-free and serves the port's PyTorch pipelines
unchanged. It registers under "spider_decoder" in the port's registry.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from spider_tpu_torch.common.profiler import span
from spider_tpu_torch.common.registry import registry
from spider_tpu_torch.models import tags


def empty_predictions() -> Dict[str, Any]:
    return dict(
        IMAGE=[], VIDEO=[], AUDIO=[], MASK=[],
        BOX=dict(bboxes=[], label_names=[], scores=[]),
        IMAGESTORY=[],
    )


def empty_predictions_text() -> Dict[str, List]:
    return dict(IMAGE=[], VIDEO=[], AUDIO=[], MASK=[], BOX=[],
                IMAGESTORY=[], IMAGESTORY_prompts=[])


@registry.register_model("spider_decoder")
class SpiderDecoder:
    """Decoders-Controller with the reference's generate() contract.

    decoders: mapping of modality -> callable:
      IMAGE/VIDEO/AUDIO: fn(prompt: str, **gen_kwargs) -> array
      BOX:   fn(image, caption) -> dict(bboxes, label_names, scores)
      MASK:  fn(image_sam, image_ori, caption, meta_info) -> mask array
    """

    def __init__(self,
                 name: str = "spider_decoder",
                 system_prompt: str = "",
                 user_prompt: str = "",
                 assistant_prompt: str = "",
                 get_prompt_embed_for_diffusion: bool = False,
                 decoders: Optional[Dict[str, Callable]] = None,
                 max_context_len: int = 4096,
                 decode_options: Optional[Dict[str, Dict[str, Any]]] = None,
                 **_unused):
        self.model_name = name
        self.system_prompt = system_prompt
        self.user_prompt = user_prompt
        self.assistant_prompt = assistant_prompt
        self.get_prompt_embed_for_diffusion = get_prompt_embed_for_diffusion
        # Per-modality generation kwargs from config (negative_prompt, eta,
        # guidance_scale, num_inference_steps overrides, ...) — merged under
        # any per-call kwargs at dispatch (decode_image/video/audio).
        self.decode_options = {k: dict(v)
                               for k, v in (decode_options or {}).items()}
        self.max_context_len = max_context_len
        self.decoders = decoders or {}

    # ----------------------------------------------------------------- decode
    def decode_image(self, samples: Dict[str, Any],
                     guidance_scale: float = 7.5,
                     num_inference_steps: int = 40):
        fn = self.decoders.get("IMAGE")
        if "llm_text_res" not in samples or fn is None:
            logging.info("no input text prompt for image generation, "
                         "or no image generation model.")
            return None
        kw = dict(guidance_scale=guidance_scale,
                  num_inference_steps=num_inference_steps,
                  **self.decode_options.get("IMAGE", {}))
        return fn(samples["llm_text_res"], **kw)

    def decode_video(self, samples: Dict[str, Any],
                     guidance_scale: float = 7.5, num_inference_steps: int = 40,
                     height: int = 320, width: int = 576, num_frames: int = 16):
        fn = self.decoders.get("VIDEO")
        if "llm_text_res" not in samples or fn is None:
            logging.info("no input text prompt for video generation, "
                         "or no video generation model.")
            return None
        kw = dict(guidance_scale=guidance_scale,
                  num_inference_steps=num_inference_steps, height=height,
                  width=width, num_frames=num_frames,
                  **self.decode_options.get("VIDEO", {}))
        return fn(samples["llm_text_res"], **kw)

    def decode_audio(self, samples: Dict[str, Any],
                     guidance_scale: float = 7.5, num_inference_steps: int = 40,
                     audio_length_in_s: float = 5.0):
        fn = self.decoders.get("AUDIO")
        if "llm_text_res" not in samples or fn is None:
            logging.info("no input text prompt for audio generation, "
                         "or no audio generation model.")
            return None
        kw = dict(guidance_scale=guidance_scale,
                  num_inference_steps=num_inference_steps,
                  audio_length_in_s=audio_length_in_s,
                  **self.decode_options.get("AUDIO", {}))
        return fn(samples["llm_text_res"], **kw)

    def decode_box(self, samples: Dict[str, Any]):
        fn = self.decoders.get("BOX")
        if fn is None or "Image_ori_array" not in samples:
            logging.info("no input image for det, or no det model.")
            return None
        if "llm_text_res" not in samples:
            logging.info("no input text prompt for det.")
            return None
        images = samples["Image_ori_array"]
        image = images[-1][0] if isinstance(images[0], list) else images[0]
        captions = samples["llm_text_res"]
        out = dict(outputs_bboxes=[], outputs_label_names=[], outputs_scores=[])
        res = fn(image, captions[0])
        # Score-threshold filter (0.3, as in the reference controller).
        bboxes, names, scores = [], [], []
        for box, label, score in zip(res["bboxes"], res["label_names"], res["scores"]):
            if score < 0.3:
                break
            bboxes.append(box)
            names.append(label)
            scores.append(score)
        out["outputs_bboxes"].append(bboxes)
        out["outputs_label_names"].append(names)
        out["outputs_scores"].append(scores)
        return out

    def decode_mask(self, samples: Dict[str, Any]):
        fn = self.decoders.get("MASK")
        if fn is None or "IMAGE_SAM" not in samples:
            logging.info("no input image for seg, or no seg model.")
            return None
        det = self.decode_box(samples)
        if det is None or not det["outputs_bboxes"][0]:
            logging.info("no object detected.")
            return None
        # Box coords come in original-image scale; rescale to the SAM input
        # (cf. spider_decoder.py:189-196).
        oh, ow = samples["Meta_info"]["original_shape"][0]
        sh, sw = samples["Meta_info"]["sam_shape"][0]
        top1 = np.asarray(det["outputs_bboxes"][0][0], dtype=np.float32)
        scale = np.array([sw / ow, sh / oh, sw / ow, sh / oh], dtype=np.float32)
        box_for_sam = top1 * scale
        images = samples["IMAGE_SAM"]
        image = images[-1][0] if isinstance(images[0], list) else images[0]
        mask = fn(image, box_for_sam, samples.get("Meta_info"))
        return [mask]

    @property
    def decode_modality(self) -> Dict[str, Optional[Callable]]:
        return dict(IMAGE=self.decode_image, VIDEO=self.decode_video,
                    AUDIO=self.decode_audio, MASK=self.decode_mask,
                    BOX=self.decode_box, IMAGESTORY=None)

    # --------------------------------------------------------------- generate
    def generate_stream(self, samples: Dict[str, Any]):
        """Generator over decoded tag spans, one at a time — each yielded
        item is (modality, llm_text_res, preds) the moment its decoder
        finishes, so callers can stream media into the chat while later
        (slower) decoders still run, like the reference's per-tag loop.
        IMAGESTORY spans yield
        preds=None (the caller owns the story pipeline)."""
        output_texts = samples["llm_text_all"][0]
        modality_list = tags.get_llm_text_modality(
            output_texts, list(self.decode_modality.keys()))
        for modality in modality_list:
            for llm_text_res in tags.get_llm_text_res(output_texts, modality):
                samples["llm_text_res"] = [llm_text_res]
                preds = None
                if modality != "IMAGESTORY":
                    with span("decoder.dispatch", modality=modality):
                        preds = self.decode_modality[modality](samples)
                yield modality, llm_text_res, preds

    def generate(self, samples: Dict[str, Any], answers: List[str],
                 predictions: Dict[str, Any], predictions_text: Dict[str, List]):
        """Parse samples['llm_text_all'][0] and dispatch each tag span (one
        ``decoder.request`` span, the root of the request's spans)."""
        with span("decoder.request"):
            return self.collect(samples, answers, predictions, predictions_text)

    def collect(self, samples: Dict[str, Any], answers: List[str],
                predictions: Dict[str, Any], predictions_text: Dict[str, List]):
        """``generate`` without its root span, for a caller that opens one
        around more work (``SpiderDecoderInfer``: the story)."""
        output_texts = samples["llm_text_all"][0]
        for modality, llm_text_res, preds in self.generate_stream(samples):
            predictions_text[modality].append(llm_text_res)
            if preds is None:
                continue
            if modality == "BOX":
                predictions["BOX"]["bboxes"].append(preds["outputs_bboxes"][0])
                predictions["BOX"]["label_names"].append(preds["outputs_label_names"][0])
                predictions["BOX"]["scores"].append(preds["outputs_scores"][0])
            elif modality in ("IMAGE", "AUDIO", "MASK"):
                predictions[modality].append(preds[0])
            else:  # VIDEO: whole clip
                predictions[modality].append(preds)
        answers.append(output_texts)
        return answers, predictions, predictions_text


def run_story_pipeline(story_fn, predictions: Dict[str, Any],
                       predictions_text: Dict[str, List]):
    """If an IMAGESTORY span was parsed, run the story pipeline (the span
    ``decoder.dispatch`` with modality IMAGESTORY) and record its results
    (shared by SpiderDecoderInfer and the streaming chat path). Returns the
    story images or None."""
    if not predictions_text["IMAGESTORY"]:
        return None
    output_texts = predictions_text["IMAGESTORY"][0]
    general_prompt, prompt_array, style_name = tags.extract_story_elements(
        output_texts)
    if (story_fn is not None and general_prompt and prompt_array
            and isinstance(prompt_array, list) and len(prompt_array) > 0
            and style_name):
        with span("decoder.dispatch", modality="IMAGESTORY"):
            preds = story_fn(general_prompt=general_prompt,
                             prompt_array=prompt_array,
                             style_name=style_name)
        predictions["IMAGESTORY"].append(preds)
        predictions_text["IMAGESTORY_prompts"].append(prompt_array)
        return preds
    logging.warning(
        "One or more required inputs for story_generation are empty!")
    return None


class SpiderDecoderInfer:
    """End-to-end wrapper: run the controller, then the story pipeline on
    any IMAGESTORY spans, all under one ``decoder.request`` span."""

    def __init__(self, cfg, decoders: Optional[Dict[str, Callable]] = None,
                 story_fn: Optional[Callable] = None):
        model_config = dict(cfg.model)
        model_cls = registry.get_model_class(model_config.pop("type"))
        if decoders is not None:
            model_config["decoders"] = decoders
        self.spider_decoder = model_cls(**model_config)
        self.story_fn = story_fn

    def __call__(self, samples: Dict[str, Any]):
        answers: List[str] = []
        predictions = empty_predictions()
        predictions_text = empty_predictions_text()
        with span("decoder.request"):
            answers, predictions, predictions_text = self.spider_decoder.collect(
                samples, answers, predictions, predictions_text)
            run_story_pipeline(self.story_fn, predictions, predictions_text)
        return answers, predictions, predictions_text
