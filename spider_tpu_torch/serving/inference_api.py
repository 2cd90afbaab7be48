"""SpiderInference: serving a trained Spider (counterpart of
spider_tpu/serving/inference_api.py).

The model is built from the training config on one device and the trained
parameters are restored from the checkpoint that a demo config names; a call
is one ``Spider.generate`` request, followed by the story path for any
``<IMAGESTORY>`` span of the answer.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Callable, Dict, Optional

import torch

from spider_tpu_torch.models import tags
from spider_tpu_torch.models.spider_decoder import empty_predictions, empty_predictions_text


def load_demo_checkpoint(model, demo_config_path: str) -> bool:
    """Restore the trained parameters of the first checkpoint of the demo
    config ({"checkpoints": [path, ...]}) that exists on disk.

    A checkpoint is a ``.pt`` file of the port's trainer
    (``RunnerBase.save_checkpoint``): its ``params`` map trainable-parameter
    names to tensors, and may hold a subset (``trainable_patterns``). Each
    is copied into the model's parameter of that name; an unknown name
    raises. A directory (an orbax checkpoint of the JAX package) raises
    NotImplementedError: the port reads no orbax checkpoint. Returns True when
    something was loaded, False (with a warning) when no entry exists."""
    with open(demo_config_path) as f:
        spec = json.load(f)
    for path in spec.get("checkpoints", []):
        if not os.path.exists(path):
            continue
        if os.path.isdir(path):
            raise NotImplementedError(
                f"{path} is a directory (an orbax checkpoint of the JAX package): the "
                "port reads only the .pt checkpoints its own trainer writes")
        named = dict(model.named_parameters())
        state = torch.load(path, map_location="cpu", weights_only=True)
        params = state.get("params", state)
        unknown = sorted(set(params) - set(named))
        if unknown:
            raise KeyError(f"{path}: no parameter of the model is named {unknown[:5]}")
        with torch.no_grad():
            for name, tensor in params.items():
                named[name].copy_(tensor)
        logging.info("SpiderInference: restored %d parameters from %s", len(params), path)
        return True
    logging.warning("demo_config %s: no checkpoint found on disk", demo_config_path)
    return False


class SpiderInference:
    """cfg: the training config (``cfg.model`` builds the model through
    ``factory.build_spider_from_config`` on `device` unless `model` is
    given; ``cfg.run.demo_config`` names the checkpoints unless
    `demo_config` does). `diffusion_pipes` attaches decoders already
    resident (a config without ``with_pipes`` then builds none of its
    own). `story_fn` renders IMAGESTORY spans
    (general_prompt, prompt_array, style_name -> images)."""

    def __init__(self, cfg, model=None, story_fn: Optional[Callable] = None,
                 demo_config: Optional[str] = None, *, device="cuda",
                 diffusion_pipes: Optional[Dict[str, Any]] = None):
        if model is None:
            from spider_tpu_torch.models.factory import build_spider_from_config

            model_config = dict(cfg.model)
            model_config.pop("type", None)
            model = build_spider_from_config(model_config, device=device)
        if diffusion_pipes:
            model.diffusion_pipes.update(diffusion_pipes)
        demo_config = demo_config or (cfg.run.get("demo_config")
                                      if hasattr(cfg, "run") else None)
        if demo_config:
            load_demo_checkpoint(model, demo_config)
        self.model = model
        self.story_fn = story_fn
        self.config = cfg

    def __call__(self, samples: Dict[str, Any], max_new_tokens: int = 64,
                 num_inference_steps: int = 40):
        predictions = empty_predictions()
        predictions_text = empty_predictions_text()
        answers, predictions, predictions_text = self.model.generate(
            samples, [], predictions, predictions_text, max_new_tokens=max_new_tokens,
            num_inference_steps=num_inference_steps)
        # the story path: each IMAGESTORY span of the answer
        if answers:
            for story_text in tags.get_llm_text_res(answers[0], "IMAGESTORY"):
                predictions_text["IMAGESTORY"].append(story_text)
                gp, pa, sn = tags.extract_story_elements(story_text)
                if self.story_fn and gp and pa and sn:
                    preds = self.story_fn(general_prompt=gp, prompt_array=pa, style_name=sn)
                    predictions["IMAGESTORY"].append(preds)
                    predictions_text["IMAGESTORY_prompts"].append(pa)
        return answers, predictions, predictions_text
