"""Diffusion schedule tables + timestep spacing, as host numpy, and the
helpers the samplers share.

SD1.5 scaled-linear betas and diffusers "leading" spacing with
``steps_offset``. Tables are float32 like the JAX package's; the step
index is a Python int in the port's denoise loop, so every per-step
scalar is read on the host and no table lives on the device. A scalar the
JAX package computes on the device in fp32 (a square root of a table
entry) is computed here in numpy float32, so it is the same number.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from powerpaint_tpu_torch.core.config import SchedulerConfig


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    config: SchedulerConfig
    alphas_cumprod: np.ndarray  # (T,) float32
    final_alpha_cumprod: float
    timesteps: np.ndarray  # (S,) int64, descending
    prev_timesteps: np.ndarray  # (S,) int64, t - T//S, may go negative
    num_steps: int

    @property
    def init_noise_sigma(self) -> float:
        return 1.0


def betas(cfg: SchedulerConfig) -> np.ndarray:
    if cfg.beta_schedule == "scaled_linear":
        return np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5,
                           cfg.num_train_timesteps, dtype=np.float64) ** 2
    if cfg.beta_schedule == "linear":
        return np.linspace(cfg.beta_start, cfg.beta_end,
                           cfg.num_train_timesteps, dtype=np.float64)
    raise ValueError(cfg.beta_schedule)


def alphas_cumprod(cfg: SchedulerConfig) -> np.ndarray:
    return np.cumprod(1.0 - betas(cfg), axis=0)


def spaced_timesteps(cfg: SchedulerConfig, num_steps: int) -> np.ndarray:
    """Descending inference timesteps."""
    T = cfg.num_train_timesteps
    if cfg.timestep_spacing == "leading":
        ratio = T // num_steps
        ts = (np.arange(num_steps) * ratio).round()[::-1].astype(np.int64)
        ts = ts + cfg.steps_offset
    elif cfg.timestep_spacing == "trailing":
        ts = np.round(np.arange(T, 0, -T / num_steps)).astype(np.int64) - 1
    elif cfg.timestep_spacing == "linspace":
        ts = np.linspace(0, T - 1, num_steps).round()[::-1].astype(np.int64)
    else:
        raise ValueError(cfg.timestep_spacing)
    return np.clip(ts, 0, T - 1)


def custom_timesteps_array(cfg: SchedulerConfig, custom) -> np.ndarray:
    """Validate a caller's timestep list (the v2 pipeline's ``timesteps``
    argument): strictly descending ints in [0, T)."""
    ts = np.asarray(custom, dtype=np.int64)
    if ts.ndim != 1 or len(ts) < 1:
        raise ValueError("timesteps must be a non-empty 1-D sequence")
    if (np.diff(ts) >= 0).any():
        raise ValueError("timesteps must be strictly descending")
    if ts[0] >= cfg.num_train_timesteps or ts[-1] < 0:
        raise ValueError(
            f"timesteps must lie in [0, {cfg.num_train_timesteps})")
    return ts


def kept_timesteps(cfg: SchedulerConfig, num_steps: int,
                   keep_steps: Optional[int] = None,
                   custom=None) -> np.ndarray:
    """Descending inference timesteps, truncated to the LAST
    ``keep_steps`` for strength < 1. ``custom`` (a caller's list) takes the
    place of the spacing formula."""
    ts = (custom_timesteps_array(cfg, custom) if custom is not None
          else spaced_timesteps(cfg, num_steps))
    num_steps = len(ts)
    if keep_steps is not None and keep_steps < num_steps:
        ts = ts[num_steps - keep_steps:]
    return ts


def make_schedule(cfg: SchedulerConfig, num_steps: int,
                  keep_steps: Optional[int] = None,
                  custom=None) -> DiffusionSchedule:
    """``keep_steps`` < ``num_steps`` keeps the LAST ``keep_steps``
    timesteps (strength < 1). With ``custom`` timesteps, the previous
    timestep of each is the next entry of the list, and -1 after the last
    (``alpha_at`` maps it to ``final_alpha_cumprod``)."""
    acp = alphas_cumprod(cfg)
    ts = kept_timesteps(cfg, num_steps, keep_steps, custom=custom)
    if custom is not None:
        prev = np.append(ts[1:], -1)
    else:
        prev = ts - cfg.num_train_timesteps // num_steps
    final = 1.0 if cfg.set_alpha_to_one else float(np.float32(acp[0]))
    return DiffusionSchedule(
        config=cfg,
        alphas_cumprod=acp.astype(np.float32),
        final_alpha_cumprod=final,
        timesteps=ts,
        prev_timesteps=prev,
        num_steps=len(ts),
    )


def alpha_at(sched: DiffusionSchedule, t: int) -> float:
    """alphas_cumprod[t], with t < 0 mapped to final_alpha_cumprod."""
    if t < 0:
        return sched.final_alpha_cumprod
    return float(sched.alphas_cumprod[t])


def add_noise(sched: DiffusionSchedule, x0: torch.Tensor, noise: torch.Tensor,
              t: int) -> torch.Tensor:
    """q(x_t | x_0) sample."""
    a = torch.tensor(float(sched.alphas_cumprod[t]), dtype=torch.float32)
    out = torch.sqrt(a) * x0.float() + torch.sqrt(1.0 - a) * noise.float()
    return out.to(x0.dtype)


def to_eps_x0(sched: DiffusionSchedule, model_out: torch.Tensor,
              x_t: torch.Tensor, t: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalize a model output into (eps, x0) per prediction_type."""
    a = torch.tensor(alpha_at(sched, t), dtype=torch.float32)
    x_t = x_t.float()
    model_out = model_out.float()
    p = sched.config.prediction_type
    if p == "epsilon":
        eps = model_out
        x0 = (x_t - torch.sqrt(1.0 - a) * eps) / torch.sqrt(a)
    elif p == "sample":
        x0 = model_out
        eps = (x_t - torch.sqrt(a) * x0) / torch.sqrt(1.0 - a)
    elif p == "v_prediction":
        x0 = torch.sqrt(a) * x_t - torch.sqrt(1.0 - a) * model_out
        eps = torch.sqrt(a) * model_out + torch.sqrt(1.0 - a) * x_t
    else:
        raise ValueError(p)
    return eps, x0


def vp_add_noise_at(sched, x0: torch.Tensor, noise: torch.Tensor,
                    i: int) -> torch.Tensor:
    """q(x_t | x0) at step index i for the VP-space schedules that expose
    ``timesteps`` and ``alphas_cumprod`` (dpm, deis, sde, lcm)."""
    t = int(sched.timesteps[min(max(i, 0), sched.num_steps - 1)])
    a = np.float32(sched.alphas_cumprod[max(t, 0)])
    out = (float(np.sqrt(a)) * x0.float()
           + float(np.sqrt(np.float32(1.0) - a)) * noise.float())
    return out.to(x0.dtype)


def sigma_add_noise_at(sched, x0: torch.Tensor, noise: torch.Tensor,
                       i: int) -> torch.Tensor:
    """x = x0 + sigma_i * noise for the sigma-space schedules, whose
    ``sigmas`` table ends with sigmas[num_steps] == 0 (euler, euler_a,
    lms)."""
    s = float(sched.sigmas[min(max(i, 0), sched.num_steps)])
    return (x0.float() + s * noise.float()).to(x0.dtype)


def sigma_scale_model_input(sched, x: torch.Tensor, i: int) -> torch.Tensor:
    """x / sqrt(sigma_i^2 + 1), the Karras input scaling; reads
    ``sched.sigmas``."""
    s = np.float32(sched.sigmas[i])
    return (x.float() / float(np.sqrt(s * s + np.float32(1.0)))).to(x.dtype)
