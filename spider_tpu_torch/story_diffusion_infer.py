"""Story generation entry of the port (twin of the root story_diffusion_infer.py):

    python -m spider_tpu_torch.story_diffusion_infer ["a fox explorer"
        ["wakes up in a forest|finds a map|..." ["Comic book"]]] [--device cuda|cpu]

A general prompt, a "|"-separated prompt array and a style name give a
consistent multi-image story from the tiny random-init SDXL story pipeline
(id_length 2, 4 Euler steps), as the root script does. Runs on cuda:0 unless
the caller asks for the CPU.
"""

from __future__ import annotations

import argparse
from typing import List

import numpy as np

DEFAULT_PROMPTS = "wakes up in a forest|finds a map|sails a river|reaches home"


def main(argv=None) -> List[np.ndarray]:
    from spider_tpu_torch.common.utils import resolve_device
    from spider_tpu_torch.models.pipelines.sdxl_story import (build_tiny_sdxl,
                                                              init_story_generation,
                                                              story_generation)

    parser = argparse.ArgumentParser(description="consistent image story (PyTorch port)")
    parser.add_argument("general_prompt", nargs="?", default="a fox explorer")
    parser.add_argument("prompts", nargs="?", default=DEFAULT_PROMPTS,
                        help='"|"-separated story prompts')
    parser.add_argument("style", nargs="?", default="Comic book")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    device = resolve_device(args.device, "story_diffusion_infer")
    pipe = init_story_generation(build_tiny_sdxl(device=device))
    frames = story_generation(pipe, general_prompt=args.general_prompt,
                              prompt_array=args.prompts.split("|"), style_name=args.style,
                              id_length=2, num_inference_steps=4)
    print(f"generated {len(frames)} frames of shape {frames[0].shape}")
    return frames


if __name__ == "__main__":
    main()
