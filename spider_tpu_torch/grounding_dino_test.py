"""Grounding DINO smoke entry of the port (twin of the root
grounding_dino_test.py):

    python -m spider_tpu_torch.grounding_dino_test [IMAGE [PROMPT]] [--device cuda|cpu]

Runs the detector (the test config, random from a seed, TinyTokenizer, at
64px) on one image, a file given or a seeded random 96x128 image, with a
text prompt, and prints the top five boxes. Runs on cuda:0 unless the caller
asks for the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    import torch

    from spider_tpu_torch.common.utils import resolve_device
    from spider_tpu_torch.models.dino import (GroundingDINO, GroundingDINOInference,
                                              grounding_dino_test)
    from spider_tpu_torch.models.factory import random_init_
    from spider_tpu_torch.models.tokenizer import TinyTokenizer

    parser = argparse.ArgumentParser(description="Grounding DINO smoke (PyTorch port)")
    parser.add_argument("image", nargs="?", default=None, help="an image file (RGB)")
    parser.add_argument("prompt", nargs="?", default="apple")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    device = resolve_device(args.device, "grounding_dino_test")

    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = random_init_(GroundingDINO(grounding_dino_test(), device).eval(), gen)
    if args.image is not None:
        from PIL import Image

        image = np.asarray(Image.open(args.image).convert("RGB"))
    else:
        image = np.random.default_rng(args.seed).integers(0, 255, (96, 128, 3), np.uint8)
    infer = GroundingDINOInference(model, TinyTokenizer(), image_size=64, max_dets=5)
    res = infer(image, args.prompt)
    for box, name, score in zip(res["bboxes"], res["label_names"], res["scores"]):
        print(f"{name}: {score:.3f} {np.round(box, 1).tolist()}")
    return res


if __name__ == "__main__":
    main()
