"""Diffusion noise schedules (counterpart of spider_tpu/models/schedulers.py).
DDIM covers SD-1.5, ZeroScope and AudioLDM with 40 steps; Euler-discrete
covers the SDXL story path with 50 (pipelines/sdxl_story.py)."""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional, Tuple, Union

import torch


def make_betas(num_train_timesteps: int = 1000, beta_start: float = 0.00085,
               beta_end: float = 0.012, schedule: str = "scaled_linear") -> torch.Tensor:
    if schedule == "scaled_linear":
        return torch.linspace(beta_start ** 0.5, beta_end ** 0.5, num_train_timesteps,
                              dtype=torch.float32) ** 2
    if schedule == "linear":
        return torch.linspace(beta_start, beta_end, num_train_timesteps, dtype=torch.float32)
    if schedule == "squaredcos_cap_v2":
        t = torch.arange(num_train_timesteps + 1, dtype=torch.float32) / num_train_timesteps
        alphas_bar = torch.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
        return (1.0 - alphas_bar[1:] / alphas_bar[:-1]).clamp(0.0, 0.999)
    raise ValueError(schedule)


@dataclasses.dataclass(frozen=True)
class DDIMScheduler:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    steps_offset: int = 1
    prediction_type: str = "epsilon"    # or "v_prediction"
    set_alpha_to_one: bool = False

    @functools.cached_property
    def alphas_cumprod(self) -> torch.Tensor:
        """[num_train_timesteps] fp32 on the CPU."""
        betas = make_betas(self.num_train_timesteps, self.beta_start, self.beta_end,
                           self.beta_schedule)
        return torch.cumprod(1.0 - betas, dim=0)

    @property
    def init_noise_sigma(self) -> float:
        return 1.0

    def timesteps(self, num_inference_steps: int) -> List[int]:
        step = self.num_train_timesteps // num_inference_steps
        return [i * step + self.steps_offset for i in reversed(range(num_inference_steps))]

    def step(self, model_output: torch.Tensor, timestep: Union[int, torch.Tensor],
             sample: torch.Tensor, num_inference_steps: int, eta: float = 0.0,
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One DDIM update in fp32, cast back to sample's dtype; eta > 0
        (with `noise`) gives the stochastic variant."""
        acp = self.alphas_cumprod
        timestep = int(timestep)
        prev_timestep = timestep - self.num_train_timesteps // num_inference_steps
        alpha_t = acp[timestep]
        if prev_timestep >= 0:
            alpha_prev = acp[prev_timestep]
        else:
            alpha_prev = torch.tensor(1.0) if self.set_alpha_to_one else acp[0]
        x = sample.float()
        eps = model_output.float()
        if self.prediction_type == "v_prediction":
            pred_x0 = torch.sqrt(alpha_t) * x - torch.sqrt(1 - alpha_t) * eps
            eps = torch.sqrt(alpha_t) * eps + torch.sqrt(1 - alpha_t) * x
        else:
            pred_x0 = (x - torch.sqrt(1 - alpha_t) * eps) / torch.sqrt(alpha_t)
        if eta > 0.0:
            if noise is None:
                raise ValueError("eta > 0 requires noise")
            variance = (1 - alpha_prev) / (1 - alpha_t) * (1 - alpha_t / alpha_prev)
            sigma = eta * torch.sqrt(variance)
            prev = (torch.sqrt(alpha_prev) * pred_x0
                    + torch.sqrt(1 - alpha_prev - sigma ** 2) * eps
                    + sigma * noise.float())
        else:
            prev = torch.sqrt(alpha_prev) * pred_x0 + torch.sqrt(1 - alpha_prev) * eps
        return prev.to(sample.dtype)


@dataclasses.dataclass(frozen=True)
class EulerDiscreteScheduler:
    """Euler method over the karras sigma parameterization (SDXL default).
    Sigmas are fp32 tensors on the CPU; the step is taken in fp32 and cast
    back to the sample's dtype."""
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    steps_offset: int = 1
    prediction_type: str = "epsilon"    # or "v_prediction"
    timestep_spacing: str = "leading"   # or "linspace"

    def sigmas_and_timesteps(self, num_inference_steps: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(sigmas [steps + 1] fp32 ending in 0, timesteps [steps] int32)."""
        betas = make_betas(self.num_train_timesteps, self.beta_start, self.beta_end,
                           self.beta_schedule)
        acp = torch.cumprod(1.0 - betas, dim=0)
        all_sigmas = torch.sqrt((1 - acp) / acp)
        if self.timestep_spacing == "leading":
            step = self.num_train_timesteps // num_inference_steps
            t = (torch.arange(num_inference_steps, dtype=torch.float32) * step).round()
            t = t.flip(0) + self.steps_offset
        else:
            t = torch.linspace(0, self.num_train_timesteps - 1, num_inference_steps,
                               dtype=torch.float32).flip(0).round()
        t = t.to(torch.int32)
        sigmas = torch.cat([all_sigmas[t.long()], torch.zeros(1, dtype=torch.float32)])
        return sigmas, t

    def init_noise_sigma(self, sigmas: torch.Tensor) -> torch.Tensor:
        if self.timestep_spacing == "linspace":
            return sigmas.max()
        return torch.sqrt(sigmas.max() ** 2 + 1)

    def scale_model_input(self, sample: torch.Tensor, sigma) -> torch.Tensor:
        return sample / torch.sqrt(torch.as_tensor(sigma, dtype=torch.float32) ** 2 + 1)

    def step(self, model_output: torch.Tensor, sigma, sigma_next,
             sample: torch.Tensor) -> torch.Tensor:
        x = sample.float()
        eps = model_output.float()
        sigma = torch.as_tensor(sigma, dtype=torch.float32)
        sigma_next = torch.as_tensor(sigma_next, dtype=torch.float32)
        if self.prediction_type == "epsilon":
            pred_x0 = x - sigma * eps
        else:
            pred_x0 = eps * (-sigma / torch.sqrt(sigma ** 2 + 1)) + x / (sigma ** 2 + 1)
        d = (x - pred_x0) / sigma
        return (x + d * (sigma_next - sigma)).to(sample.dtype)


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: float = 10000.0,
                       flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0) -> torch.Tensor:
    """Sinusoidal timestep embeddings [B, dim] fp32 (diffusers convention)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=timesteps.device)
                      / (half - downscale_freq_shift))
    args = timesteps.float()[:, None] * freqs[None]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb
