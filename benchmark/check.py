"""What decides ``correct``: the program's own outputs against the plain
fp32 reference, at the timed sizes, on requests of the window drawn from the
seed.

For each sampled request and each of its sampled denoise steps k:
  noise_max_abs  the initial latents the program drew against the same draw
                 from the request's generator (exact: limit 0);
  text_rel_l2    the program's conditioning [uncond; cond], as the UNet got
                 it, against the reference's text encoder on the same tokens;
  unet_rel_l2    the program's CFG noise prediction at step k against the
                 reference UNet's at the program's own step-k inputs;
  ddim_rel       the program's latents after step k against the reference's
                 guidance and DDIM step from the program's own latents and
                 noise prediction, over the size of that step;
  vae_rel_l2     the program's returned frames or image against the
                 reference's decode of the program's final latents, over the
                 output's spread about its mean.
Each number is the largest over the sample. A relative L2 is
||a - b|| / ||b||. The reference follows the program step by step from its
own state (PERF.md says why); the start and the decode are checked by
themselves.

The control (``control_numbers``) puts the reference computed in fp8 in the
program's place at the same inputs.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.reference import build, ddim, tokenizer
from benchmark.reference.layers import set_fp8

NAMES = ("noise_max_abs", "text_rel_l2", "unet_rel_l2", "ddim_rel", "vae_rel_l2")


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def spread_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| over ||b - mean(b)||."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / (b - b.mean()).norm().clamp_min(1e-30))


def to_output(img: torch.Tensor, video: bool) -> torch.Tensor:
    """The decoder's raw images -> what the pipeline returns: uint8 values
    (truncated) for a video, [0, 1] for an image."""
    img = (img / 2 + 0.5).clamp(0.0, 1.0)
    return (img * 255.0).to(torch.uint8).float() if video else img


class Reference:
    """The configuration's reference models in fp32 on `device`, with the
    run's weights, and the operations the comparison needs."""

    def __init__(self, config: dict, workload: dict, values: Dict[str, torch.Tensor], device):
        self.config, self.point, self.device = config, workload["point"], device
        self.video = config["unet_as_run"]["temporal"]
        self.text, self.unet, self.vae = build.models(config, device)
        self.load(values)
        self.sched = config["scheduler"]
        self.steps = self.point["num_inference_steps"]
        self.timesteps = ddim.timesteps(self.sched, self.steps)

    def load(self, values: Dict[str, torch.Tensor]) -> None:
        for module, prefix in ((self.text, "text_encoder"), (self.unet, "unet"),
                               (self.vae, "vae")):
            build.load(module, prefix, values)

    def fp8(self, on: bool) -> None:
        for m in (self.text, self.unet, self.vae):
            set_fp8(m, on)

    @torch.no_grad()
    def context(self, caption: str) -> torch.Tensor:
        """[uncond; cond] conditioning [2, 77, D] of one span."""
        n = self.config["text_encoder_as_run"]["max_position_embeddings"]
        ids = torch.tensor(tokenizer.batch_ids(["", caption], n), device=self.device)
        return self.text(ids)

    @torch.no_grad()
    def eps(self, latents: torch.Tensor, k: int, context: torch.Tensor) -> torch.Tensor:
        lat = latents.to(self.device, torch.float32)
        t = torch.full((2 * lat.shape[0],), self.timesteps[k], device=self.device)
        return self.unet(torch.cat([lat, lat]), t, context.to(self.device, torch.float32))

    def step(self, latents, eps, k: int) -> torch.Tensor:
        eu, ec = eps.to(self.device).float().chunk(2)
        return ddim.guided_step(self.sched, self.steps, self.timesteps[k],
                                latents.to(self.device), eu, ec, self.point["guidance_scale"])

    @torch.no_grad()
    def decode(self, final: torch.Tensor, block: int = 4) -> torch.Tensor:
        """What the pipeline returns for these final latents, on the host,
        decoded a few frames at a time."""
        flat = final.to(self.device, torch.float32)
        flat = flat.reshape((-1,) + flat.shape[-3:])
        out = [to_output(self.vae(flat[i:i + block]), self.video).cpu()
               for i in range(0, flat.shape[0], block)]
        return torch.cat(out)


def noise(rec: dict, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(rec["generator_seed"])
    return torch.randn(tuple(rec["latents"][0].shape), generator=gen, dtype=torch.float32,
                       device=device)


def program_numbers(ref: Reference, records: List[dict]) -> Dict[str, float]:
    """The five numbers, each the largest over the recorded requests."""
    worst = dict.fromkeys(NAMES, 0.0)

    def keep(name, value):
        worst[name] = max(worst[name], value)

    for rec in records:
        keep("noise_max_abs", float((rec["latents"][0].to(ref.device)
                                     - noise(rec, ref.device)).abs().max()))
        keep("text_rel_l2", rel_l2(rec["context"].to(ref.device), ref.context(rec["caption"])))
        for k in rec["steps"]:
            keep("unet_rel_l2", rel_l2(rec["eps"][k].to(ref.device),
                                       ref.eps(rec["latents"][k], k, rec["context"])))
            want = ref.step(rec["latents"][k], rec["eps"][k], k)
            got = rec["latents"][k + 1].to(ref.device)
            keep("ddim_rel", rel_l2(got - rec["latents"][k].to(ref.device),
                                    want - rec["latents"][k].to(ref.device)))
        want = ref.decode(rec["latents"][ref.steps])
        got = torch.as_tensor(np.asarray(rec["output"], dtype=np.float32)).reshape(want.shape)
        keep("vae_rel_l2", spread_rel(got, want))
    return worst


def control_numbers(ref: Reference, records: List[dict]) -> Dict[str, float]:
    """The numbers of the reference computed in fp8 put in the program's
    place, at the program's recorded inputs: its conditioning, its noise
    prediction at each sampled step, its decode of the final latents."""
    worst = dict(text_rel_l2=0.0, unet_rel_l2=0.0, vae_rel_l2=0.0)
    for rec in records:
        want_ctx = ref.context(rec["caption"])
        want = {k: ref.eps(rec["latents"][k], k, rec["context"]) for k in rec["steps"]}
        want_img = ref.decode(rec["latents"][ref.steps])
        ref.fp8(True)
        try:
            worst["text_rel_l2"] = max(worst["text_rel_l2"],
                                       rel_l2(ref.context(rec["caption"]), want_ctx))
            for k in rec["steps"]:
                worst["unet_rel_l2"] = max(worst["unet_rel_l2"], rel_l2(
                    ref.eps(rec["latents"][k], k, rec["context"]), want[k]))
            worst["vae_rel_l2"] = max(worst["vae_rel_l2"], spread_rel(
                ref.decode(rec["latents"][ref.steps]), want_img))
        finally:
            ref.fp8(False)
    return worst


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number within its limit, over the numbers the limits name."""
    return all(numbers[n] <= limits[n] for n in limits)
