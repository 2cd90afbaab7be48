"""The reference models of a configuration file, in fp32, and the shapes of
its operating point."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from benchmark.reference.clip_text import CLIPText
from benchmark.reference.unet import UNet
from benchmark.reference.vae import VAEDecode


def models(config: dict, device) -> Tuple[CLIPText, UNet, VAEDecode]:
    """(text encoder, UNet, VAE decode) of `config` on `device`, fp32, in
    eval mode, weights as constructed."""
    with torch.device(device):
        return (CLIPText(config["text_encoder_as_run"]).eval(),
                UNet(config["unet_as_run"]).eval(),
                VAEDecode(config["vae_as_run"]).eval())


def load(module: torch.nn.Module, prefix: str, values: Dict[str, torch.Tensor]) -> None:
    """Every tensor of `module` from values[prefix + "." + name], in fp32;
    a name the values lack, or a shape that differs, raises."""
    own = module.state_dict()
    state = {}
    for name, t in own.items():
        key = f"{prefix}.{name}"
        if key not in values:
            raise KeyError(f"the weights have no {key}")
        if tuple(values[key].shape) != tuple(t.shape):
            raise ValueError(f"{key}: weights {tuple(values[key].shape)}, "
                             f"reference {tuple(t.shape)}")
        state[name] = values[key].float()
    module.load_state_dict(state, strict=True)


def latent_shape(config: dict, point: dict, batch: int = 1) -> Tuple[int, ...]:
    """[B, h, w, C] for an image, [B, F, h, w, C] for a video."""
    vae = config["vae_as_run"]
    factor = 2 ** (len(vae["block_out_channels"]) - 1)
    hw = (point["height"] // factor, point["width"] // factor,
          config["unet_as_run"]["in_channels"])
    if config["unet_as_run"]["temporal"]:
        return (batch, point["num_frames"]) + hw
    return (batch,) + hw


def frames(lat_shape: Tuple[int, ...]) -> int:
    """Images the VAE decodes for latents of this shape."""
    n = 1
    for d in lat_shape[:-3]:
        n *= d
    return n
