"""Model operations of one request, counted from the configuration's widths
and the cell's shapes: the reference models built on the meta device and run
under ``torch.utils.flop_counter`` (matrix products, convolutions and
attention, 2 operations a multiply-add). Nothing the program dispatches
enters the count."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import build


def _count(fn) -> int:
    with FlopCounterMode(display=False) as mode:
        fn()
    return int(mode.get_total_flops())


def request_flops(config: dict, point: dict) -> dict:
    """{part: operations} of one span at the operating point: the text
    encoder twice (the prompt and the empty negative prompt, batch 1 each),
    ``steps`` CFG calls of the UNet at batch 2, and the VAE decode of every
    frame; "total" sums them."""
    dev = torch.device("meta")
    text, unet, vae = build.models(config, device=dev)
    lat = build.latent_shape(config, point, batch=1)
    ids = torch.zeros((1, config["text_encoder_as_run"]["max_position_embeddings"]),
                      dtype=torch.long, device=dev)
    ctx = torch.zeros((2, ids.shape[1], config["text_encoder_as_run"]["hidden_size"]),
                      device=dev)
    with torch.no_grad():
        text_f = _count(lambda: text(ids))
        unet_f = _count(lambda: unet(torch.zeros((2,) + lat[1:], device=dev),
                                     torch.zeros(2, device=dev), ctx))
        frames = torch.zeros((build.frames(lat),) + lat[-3:], device=dev)
        vae_f = _count(lambda: vae(frames))
    parts = dict(text_encoder=2 * text_f, unet=point["num_inference_steps"] * unet_f,
                 vae_decode=vae_f, unet_call=unet_f)
    parts["total"] = parts["text_encoder"] + parts["unet"] + parts["vae_decode"]
    return parts
