"""LCM sampler (latent consistency model, arXiv 2310.04378), stochastic.

- The timesteps come from the coarse ``original_inference_steps`` grid the
  consistency distillation trained on (k = T / origin; grid k-1, 2k-1,
  ...), subsampled evenly for the step count; more steps than the grid
  has is an error.
- Each step predicts x0 from epsilon and applies the consistency boundary
  conditions

      c_skip = sd^2 / (s^2 + sd^2),   c_out = s / sqrt(s^2 + sd^2),
      s = timestep * timestep_scaling,  sd = 0.5,
      denoised = c_out * x0_pred + c_skip * x,

  then, on every step but the last, re-noises ``denoised`` to the next
  timestep with fresh Gaussian noise (the pipeline hands ``step`` one
  noise tensor per iteration from each image's own generator).

A copy of the JAX package's ``make_lcm_schedule``; the guidance embedding
of an LCM-distilled UNet is the v2 pipeline's (``time_cond_proj_dim``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from powerpaint_tpu_torch.core.config import SchedulerConfig
from powerpaint_tpu_torch.schedulers.common import alphas_cumprod, vp_add_noise_at

stochastic = True

SIGMA_DATA = 0.5


@dataclasses.dataclass(frozen=True)
class LCMSchedule:
    config: SchedulerConfig
    timesteps: np.ndarray  # (S,) descending
    alphas_cumprod: np.ndarray
    c_skip: np.ndarray  # (S,)
    c_out: np.ndarray  # (S,)
    a_next: np.ndarray  # (S,) alphas_cumprod at t_{i+1} (the last: 1)
    num_steps: int

    @property
    def init_noise_sigma(self) -> float:
        return 1.0


def make_lcm_schedule(cfg: SchedulerConfig, num_steps: int,
                      keep_steps: Optional[int] = None) -> LCMSchedule:
    acp = alphas_cumprod(cfg)
    T = cfg.num_train_timesteps
    origin = cfg.original_inference_steps
    if num_steps > origin:
        raise ValueError(
            f"LCM supports at most original_inference_steps={origin} steps, "
            f"got {num_steps}")
    k = T // origin
    grid_desc = (np.arange(1, origin + 1) * k - 1)[::-1]
    idx = np.floor(np.linspace(0, len(grid_desc), num=num_steps,
                               endpoint=False)).astype(np.int64)
    ts = grid_desc[idx]
    if keep_steps is not None and keep_steps < len(ts):
        ts = ts[len(ts) - keep_steps:]
    S = len(ts)

    scaled = ts.astype(np.float64) * cfg.timestep_scaling
    c_skip = SIGMA_DATA ** 2 / (scaled ** 2 + SIGMA_DATA ** 2)
    c_out = scaled / np.sqrt(scaled ** 2 + SIGMA_DATA ** 2)
    a_next = np.ones(S)
    for i in range(S - 1):
        a_next[i] = acp[int(ts[i + 1])]

    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return LCMSchedule(config=cfg, timesteps=ts, alphas_cumprod=f32(acp),
                       c_skip=f32(c_skip), c_out=f32(c_out),
                       a_next=f32(a_next), num_steps=S)


add_noise_at = vp_add_noise_at


def init_state(sched: LCMSchedule, shape, device) -> None:
    return None


def scale_model_input(sched: LCMSchedule, x: torch.Tensor,
                      i: int) -> torch.Tensor:
    return x


def step(sched: LCMSchedule, state, model_out: torch.Tensor, i: int,
         x: torch.Tensor,
         noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, None]:
    a = np.float32(sched.alphas_cumprod[int(sched.timesteps[i])])
    alpha_t = float(np.sqrt(a))
    sigma_t = float(np.sqrt(np.float32(1.0) - a))
    xf = x.float()
    x0 = (xf - sigma_t * model_out.float()) / alpha_t
    denoised = float(sched.c_out[i]) * x0 + float(sched.c_skip[i]) * xf
    if i >= sched.num_steps - 1:
        return denoised.to(x.dtype), state
    an = np.float32(sched.a_next[i])
    x_next = float(np.sqrt(an)) * denoised
    if noise is not None:
        x_next = x_next + float(np.sqrt(np.float32(1.0) - an)) * noise.float()
    return x_next.to(x.dtype), state
