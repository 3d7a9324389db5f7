"""DDIM sampler over (schedule, step index): the deterministic eta = 0
update and the eta > 0 stochastic term (Song et al. 2020, eq. 12);
``clip_sample=False`` (SD convention). DDIM is memoryless: its state is
None, kept for the registry's uniform interface."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from powerpaint_tpu_torch.schedulers.common import (
    DiffusionSchedule,
    add_noise,
    alpha_at,
    to_eps_x0,
)


def add_noise_at(sched: DiffusionSchedule, x0: torch.Tensor,
                 noise: torch.Tensor, i: int) -> torch.Tensor:
    """q(x_t | x0) at step index i of the (possibly truncated) schedule."""
    t = int(sched.timesteps[min(max(i, 0), sched.num_steps - 1)])
    return add_noise(sched, x0, noise, t)


def init_state(sched: DiffusionSchedule, shape, device) -> None:
    return None


def scale_model_input(sched: DiffusionSchedule, x: torch.Tensor,
                      i: int) -> torch.Tensor:
    return x


def step(sched: DiffusionSchedule, state, model_out: torch.Tensor, i: int,
         x: torch.Tensor, *, eta: float = 0.0,
         noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, None]:
    """x_t -> x_{t-1}; ``noise`` is used only with ``eta`` > 0."""
    t = int(sched.timesteps[i])
    t_prev = int(sched.prev_timesteps[i])
    a_t = torch.tensor(alpha_at(sched, t), dtype=torch.float32)
    a_prev = torch.tensor(alpha_at(sched, t_prev), dtype=torch.float32)
    eps, x0 = to_eps_x0(sched, model_out, x, t)
    if eta > 0.0 and noise is not None:
        var = (1.0 - a_prev) / (1.0 - a_t) * (1.0 - a_t / a_prev)
        sigma = eta * torch.sqrt(var)
        x_prev = (torch.sqrt(a_prev) * x0
                  + torch.sqrt(torch.clamp(1.0 - a_prev - sigma ** 2, min=0.0)) * eps
                  + sigma * noise.float())
    else:
        x_prev = torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps
    return x_prev.to(x.dtype), state
