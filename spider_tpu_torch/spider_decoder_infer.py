"""SpiderDecoder inference entry of the port (twin of the root
spider_decoder_infer.py):

    python -m spider_tpu_torch.spider_decoder_infer [--full] [--device cuda|cpu]

Tagged LLM text goes straight into the Decoders-Controller
(``SpiderDecoderInfer``), which routes each span to its decoder.
``build_default_decoders`` makes every decoder the reference's controller
routes: IMAGE, VIDEO and AUDIO diffusion, BOX (Grounding DINO) and MASK
(Grounding DINO's top box prompting SAM). Tiny random pipelines by default;
``tiny=False`` the full-size models at their operating points, random from a
seed or loaded from ``weight_paths``. Runs on cuda:0 unless the caller asks
for the CPU.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Callable, Dict, Optional

import numpy as np

# Generation kwargs the diffusion pipelines take beyond the operating point
# each decoder pins (a config's decode_options ride through here).
_PASSTHROUGH = ("negative_prompt", "eta", "generator")


def _gen_kwargs(kw, drop=()):
    return {k: v for k, v in kw.items() if k in _PASSTHROUGH and k not in drop}


def build_default_decoders(tiny: bool = True, with_grounding: bool = True,
                           weight_paths: Optional[Dict[str, str]] = None, *, device,
                           dtype=None, seed: int = 0) -> Dict[str, Callable]:
    """Resident decoder callables for every modality the reference's
    Decoders-Controller routes (spider_decoder_infer.py:26-160).

    tiny=True: random smoke-scale pipelines with clamped operating points,
    fp32. tiny=False: the full-size architectures at their operating points
    in `dtype` (bf16 by default); `weight_paths` maps a kind ('sd15',
    'zeroscope', 'audioldm', 'sam', 'grounding_dino') to its checkpoint,
    and a kind without one is random from `seed`. BOX is Grounding DINO's
    ``inference_detector`` contract; MASK(image_sam, box, meta_info) is SAM's
    ``predict_box`` on the SAM-sized image with the box rescaled by the
    controller, -> low-res masks [1, 4h, 4w] fp32 on the host.
    """
    import torch

    weight_paths = dict(weight_paths or {})
    if tiny:
        from spider_tpu_torch.models.pipelines.ad import build_tiny_ad
        from spider_tpu_torch.models.pipelines.sd import build_tiny_sd
        from spider_tpu_torch.models.pipelines.vd import build_tiny_vd

        sd = build_tiny_sd(device=device, seed=seed)
        vd = build_tiny_vd(device=device, seed=seed)
        ad = build_tiny_ad(device=device, seed=seed)

        # smoke scale: clamp the controller's operating points (320x576x16f,
        # 40 steps, 5 s) to sizes the tiny VAEs afford
        def image_fn(prompts, num_inference_steps=40, **kw):
            return sd(prompt=prompts, num_inference_steps=min(num_inference_steps, 8),
                      **_gen_kwargs(kw))

        def video_fn(prompts, num_inference_steps=40, **kw):
            return vd(prompt=prompts, num_inference_steps=min(num_inference_steps, 8),
                      height=32, width=32, num_frames=4, **_gen_kwargs(kw))

        def audio_fn(prompts, num_inference_steps=40, audio_length_in_s=5.0, **kw):
            return ad(prompt=prompts, num_inference_steps=min(num_inference_steps, 8),
                      audio_length_in_s=min(audio_length_in_s, 1.0), **_gen_kwargs(kw))
    else:
        from spider_tpu_torch.models.factory import from_pretrained

        dtype = dtype or torch.bfloat16
        full = dict(device=device, dtype=dtype, seed=seed)
        sd = from_pretrained("sd15", weight_paths.get("sd15"), **full)
        vd = from_pretrained("zeroscope", weight_paths.get("zeroscope"), **full)
        ad = from_pretrained("audioldm", weight_paths.get("audioldm"), **full)

        def image_fn(prompts, num_inference_steps=40, **kw):
            return sd(prompt=prompts, num_inference_steps=num_inference_steps,
                      guidance_scale=kw.get("guidance_scale", 7.5),
                      **_gen_kwargs(kw, drop=("guidance_scale",)))

        def video_fn(prompts, num_inference_steps=40, **kw):
            return vd(prompt=prompts, num_inference_steps=num_inference_steps,
                      height=kw.get("height", 320), width=kw.get("width", 576),
                      num_frames=kw.get("num_frames", 16), **_gen_kwargs(kw))

        def audio_fn(prompts, num_inference_steps=40, audio_length_in_s=5.0, **kw):
            return ad(prompt=prompts, num_inference_steps=num_inference_steps,
                      audio_length_in_s=audio_length_in_s, **_gen_kwargs(kw))

    decoders: Dict[str, Callable] = {"IMAGE": image_fn, "VIDEO": video_fn, "AUDIO": audio_fn}
    if with_grounding:
        dino, sam = build_grounding(tiny, weight_paths, device=device, dtype=dtype, seed=seed)
        decoders["BOX"] = dino
        decoders["MASK"] = mask_decoder(sam)
    return decoders


def build_grounding(tiny: bool = True, weight_paths: Optional[Dict[str, str]] = None, *,
                    device, dtype=None, seed: int = 0):
    """(GroundingDINOInference, Sam): the test configs with TinyTokenizer at
    64px (fp32), or the full-size ones (``from_pretrained``) in `dtype`."""
    import torch

    from spider_tpu_torch.models.factory import from_pretrained, random_init_

    weight_paths = dict(weight_paths or {})
    if not tiny:
        dtype = dtype or torch.bfloat16
        full = dict(device=device, dtype=dtype, seed=seed)
        return (from_pretrained("grounding_dino", weight_paths.get("grounding_dino"), **full),
                from_pretrained("sam", weight_paths.get("sam"), **full))
    from spider_tpu_torch.models.dino import (GroundingDINO, GroundingDINOInference,
                                              grounding_dino_test)
    from spider_tpu_torch.models.sam import Sam, sam_tiny
    from spider_tpu_torch.models.tokenizer import TinyTokenizer

    gen = torch.Generator(device=device).manual_seed(seed)
    dino = random_init_(GroundingDINO(grounding_dino_test(), device).eval(), gen)
    sam = random_init_(Sam(sam_tiny(), device).eval(), gen)
    return GroundingDINOInference(dino, TinyTokenizer(), image_size=64), sam


def mask_decoder(sam) -> Callable:
    """MASK(image_sam, box, meta_info) -> SAM's low-res masks [1, 4h, 4w]
    for one box prompt on one SAM-sized image (CHW or HWC); the function
    carries the model as ``.sam``."""
    import torch

    def mask_fn(image_sam, box, meta_info=None) -> np.ndarray:
        img = np.asarray(image_sam, np.float32)
        if img.ndim == 3:
            img = img[None]
        if img.shape[-1] == 3 and img.shape[1] != 3:        # HWC -> CHW
            img = img.transpose(0, 3, 1, 2)
        dev = sam.device
        with torch.inference_mode():
            masks = sam.predict_box(torch.from_numpy(np.ascontiguousarray(img)).to(dev),
                                    torch.as_tensor(np.asarray(box, np.float32)).reshape(
                                        1, 1, 4).to(dev))
        return masks[0].float().cpu().numpy()

    mask_fn.sam = sam
    return mask_fn


def main(argv=None):
    from spider_tpu_torch.common.config import Config
    from spider_tpu_torch.common.utils import resolve_device
    from spider_tpu_torch.models import spider_decoder  # noqa: F401 (registers the model)
    from spider_tpu_torch.models.spider_decoder import SpiderDecoderInfer

    parser = argparse.ArgumentParser(description="SpiderDecoder inference (PyTorch port)")
    parser.add_argument("--full", action="store_true",
                        help="the full-size decoders (random weights) instead of the tiny ones")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    device = resolve_device(args.device, "spider_decoder_infer")
    cfg = Config.fromfile(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "train_configs", "spider_decoder_cfg.py"))
    infer = SpiderDecoderInfer(cfg, decoders=build_default_decoders(tiny=not args.full,
                                                                    device=device))
    ask_info: Dict[str, Any] = {"llm_text_all":
                                ["<IMAGE>apple</IMAGE><VIDEO>dog</VIDEO><AUDIO>cat</AUDIO>"]}
    answers, predictions, predictions_text = infer(ask_info)
    print("answers:", answers)
    print("predictions_text:", predictions_text)
    print("IMAGE:", len(predictions["IMAGE"]), "VIDEO:", len(predictions["VIDEO"]),
          "AUDIO:", len(predictions["AUDIO"]))
    return answers, predictions, predictions_text


if __name__ == "__main__":
    main()
