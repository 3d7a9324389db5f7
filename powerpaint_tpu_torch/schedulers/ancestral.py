"""Euler-ancestral sampler ("Euler a"), stochastic, in sigma space.

Each step takes a deterministic Euler sub-step down to ``sigma_down`` and
re-injects fresh Gaussian noise at ``sigma_up``, which keeps the marginal
variance:

    sigma_up^2   = sigma_next^2 * (sigma^2 - sigma_next^2) / sigma^2
    sigma_down^2 = sigma_next^2 - sigma_up^2
    x' = x + (sigma_down - sigma) * eps + sigma_up * z,  z ~ N(0, I)

The pipeline hands ``step`` one noise tensor per iteration, drawn from
each image's own generator (``pipelines.common``). A copy of the JAX
package's ``make_ancestral_schedule``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from powerpaint_tpu_torch.core.config import SchedulerConfig
from powerpaint_tpu_torch.schedulers.common import (
    alphas_cumprod,
    kept_timesteps,
    sigma_add_noise_at,
    sigma_scale_model_input,
)

stochastic = True


@dataclasses.dataclass(frozen=True)
class AncestralSchedule:
    config: SchedulerConfig
    timesteps: np.ndarray  # (S,)
    sigmas: np.ndarray  # (S+1,) fp32, sigmas[-1] = 0
    sigma_down: np.ndarray  # (S,) fp32
    sigma_up: np.ndarray  # (S,) fp32
    num_steps: int
    init_noise_sigma_val: float

    @property
    def init_noise_sigma(self) -> float:
        return self.init_noise_sigma_val


def make_ancestral_schedule(cfg: SchedulerConfig, num_steps: int,
                            keep_steps: Optional[int] = None) -> AncestralSchedule:
    acp = alphas_cumprod(cfg)
    ts = kept_timesteps(cfg, num_steps, keep_steps)
    S = len(ts)
    sig = np.sqrt((1.0 - acp[ts]) / acp[ts])
    sigmas = np.concatenate([sig, [0.0]])
    up = np.zeros(S)
    down = np.zeros(S)
    for i in range(S):
        s, sn = sigmas[i], sigmas[i + 1]
        up2 = sn ** 2 * (s ** 2 - sn ** 2) / s ** 2
        up[i] = np.sqrt(up2)
        down[i] = np.sqrt(max(sn ** 2 - up2, 0.0))
    return AncestralSchedule(
        config=cfg, timesteps=ts, sigmas=sigmas.astype(np.float32),
        sigma_down=down.astype(np.float32), sigma_up=up.astype(np.float32),
        num_steps=S, init_noise_sigma_val=float(np.sqrt(sigmas[0] ** 2 + 1.0)))


add_noise_at = sigma_add_noise_at
scale_model_input = sigma_scale_model_input


def init_state(sched: AncestralSchedule, shape, device) -> None:
    return None


def step(sched: AncestralSchedule, state, model_out: torch.Tensor, i: int,
         x: torch.Tensor,
         noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, None]:
    dt = np.float32(sched.sigma_down[i]) - np.float32(sched.sigmas[i])
    x_next = x.float() + float(dt) * model_out.float()
    if noise is not None:
        x_next = x_next + float(sched.sigma_up[i]) * noise.float()
    return x_next.to(x.dtype), state
