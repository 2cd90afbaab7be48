"""DDIM with classifier-free guidance, plain fp32: the scaled-linear beta
schedule of SD (1000 training steps, betas 0.00085 to 0.012), "leading"
timesteps with offset 1, eta 0, the final step to alpha_bar[0]
(set_alpha_to_one false)."""

from __future__ import annotations

from typing import List

import torch


def alphas_cumprod(sched: dict) -> torch.Tensor:
    betas = torch.linspace(sched["beta_start"] ** 0.5, sched["beta_end"] ** 0.5,
                           sched["num_train_timesteps"], dtype=torch.float64) ** 2
    return torch.cumprod(1.0 - betas, dim=0)


def timesteps(sched: dict, steps: int) -> List[int]:
    stride = sched["num_train_timesteps"] // steps
    return [i * stride + sched["steps_offset"] for i in reversed(range(steps))]


def guided_step(sched: dict, steps: int, t: int, latents: torch.Tensor,
                eps_uncond: torch.Tensor, eps_cond: torch.Tensor,
                scale: float) -> torch.Tensor:
    """The latents after the step at timestep t, from the two halves of the
    CFG pair's noise prediction."""
    acp = alphas_cumprod(sched)
    prev = t - sched["num_train_timesteps"] // steps
    a_t = float(acp[t])
    a_prev = float(acp[prev]) if prev >= 0 else float(acp[0])
    x = latents.double()
    eps = eps_uncond.double() + scale * (eps_cond.double() - eps_uncond.double())
    x0 = (x - (1 - a_t) ** 0.5 * eps) / a_t ** 0.5
    return (a_prev ** 0.5 * x0 + (1 - a_prev) ** 0.5 * eps).float()
