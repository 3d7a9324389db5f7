"""Euler discrete sampler, in sigma space.

sigma = sqrt((1 - acp) / acp); the latents live unscaled in sigma space,
so the UNet sees ``x / sqrt(sigma^2 + 1)`` (``scale_model_input``) and the
start is ``noise * init_noise_sigma``, sqrt(sigma_max^2 + 1), about 14.6 at
SD1.5. For epsilon prediction the ODE's derivative is the model output, so
a step is x + (sigma_{i+1} - sigma_i) * eps. A copy of the JAX package's
``make_euler_schedule``.
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


@dataclasses.dataclass(frozen=True)
class EulerSchedule:
    config: SchedulerConfig
    timesteps: np.ndarray  # (S,) descending
    sigmas: np.ndarray  # (S+1,) fp32, sigmas[-1] = 0
    num_steps: int
    init_noise_sigma_val: float

    @property
    def init_noise_sigma(self) -> float:
        return self.init_noise_sigma_val


def make_euler_schedule(cfg: SchedulerConfig, num_steps: int,
                        keep_steps: Optional[int] = None) -> EulerSchedule:
    acp = alphas_cumprod(cfg)
    ts = kept_timesteps(cfg, num_steps, keep_steps)
    sig = np.sqrt((1.0 - acp[ts]) / acp[ts])
    sigmas = np.concatenate([sig, [0.0]]).astype(np.float32)
    return EulerSchedule(
        config=cfg, timesteps=ts, sigmas=sigmas, num_steps=len(ts),
        init_noise_sigma_val=float(np.sqrt(sigmas[0] ** 2 + 1.0)))


# x = x0 + sigma_i * noise; at i == num_steps sigma is 0 and this is x0
add_noise_at = sigma_add_noise_at
scale_model_input = sigma_scale_model_input


def init_state(sched: EulerSchedule, shape, device) -> None:
    return None


def step(sched: EulerSchedule, state, model_out: torch.Tensor, i: int,
         x: torch.Tensor) -> Tuple[torch.Tensor, None]:
    """Euler step in sigma space; epsilon prediction."""
    dt = np.float32(sched.sigmas[i + 1]) - np.float32(sched.sigmas[i])
    x_next = x.float() + float(dt) * model_out.float()
    return x_next.to(x.dtype), state
