"""DPM-Solver++ 2M SDE (stochastic multistep, data prediction), the
"DPM++ 2M SDE" sampler. In lambda = log(alpha / sigma) with h =
lambda_next - lambda_cur > 0:

    x' = A x + B0 m_t + B1 m_{i-1} + N z,   z ~ N(0, I)
    A  = (sigma_next / sigma_cur) exp(-h)
    B  = alpha_next (1 - exp(-2h)),  (B0, B1) = (B (1 + 1/(2r)), -B/(2r))
    N  = sigma_next sqrt(1 - exp(-2h))

with r = h_prev / h (the first step and the lower-order final one: B0 = B,
B1 = 0). Every coefficient is a host table (a copy of the JAX package's
``make_sde_schedule``). The pipeline hands ``step`` one noise tensor per
iteration from each image's own generator.
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
    vp_add_noise_at,
)

stochastic = True


@dataclasses.dataclass
class SDEState:
    m0: torch.Tensor  # the previous x0 prediction


@dataclasses.dataclass(frozen=True)
class SDESchedule:
    config: SchedulerConfig
    alphas_cumprod: np.ndarray
    timesteps: np.ndarray
    A: np.ndarray
    B0: np.ndarray  # weight on the newest x0 prediction
    B1: np.ndarray  # weight on the one before
    N: np.ndarray  # the noise scale
    num_steps: int

    @property
    def init_noise_sigma(self) -> float:
        return 1.0


def make_sde_schedule(cfg: SchedulerConfig, num_steps: int,
                      keep_steps: Optional[int] = None) -> SDESchedule:
    acp = alphas_cumprod(cfg)
    ts = kept_timesteps(cfg, num_steps, keep_steps)
    S = len(ts)
    alpha = np.sqrt(acp)
    sigma = np.sqrt(1.0 - acp)
    lam = np.log(alpha) - np.log(sigma)

    def bnd(t):
        t = max(int(t), 0)
        return alpha[t], sigma[t], lam[t]

    A, B0, B1, N = (np.zeros(S) for _ in range(4))
    for i in range(S):
        t_t = int(ts[i + 1]) if i + 1 < S else 0
        a_t, s_t, l_t = bnd(t_t)
        a_s, s_s, l_s = bnd(int(ts[i]))
        h = l_t - l_s
        em2h = np.exp(-2.0 * h)
        A[i] = (s_t / s_s) * np.exp(-h)
        B = a_t * (1.0 - em2h)
        N[i] = s_t * np.sqrt(max(1.0 - em2h, 0.0))
        if i == 0 or (cfg.lower_order_final and i == S - 1):
            B0[i], B1[i] = B, 0.0
        else:
            r = (l_s - bnd(int(ts[i - 1]))[2]) / h
            B0[i] = B * (1.0 + 0.5 / r)
            B1[i] = -B * 0.5 / r

    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return SDESchedule(config=cfg, alphas_cumprod=f32(acp), timesteps=ts,
                       A=f32(A), B0=f32(B0), B1=f32(B1), N=f32(N),
                       num_steps=S)


add_noise_at = vp_add_noise_at


def init_state(sched: SDESchedule, shape, device) -> SDEState:
    return SDEState(m0=torch.zeros(shape, dtype=torch.float32, device=device))


def scale_model_input(sched: SDESchedule, x: torch.Tensor,
                      i: int) -> torch.Tensor:
    return x


def step(sched: SDESchedule, state: SDEState, model_out: torch.Tensor,
         i: int, x: torch.Tensor,
         noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, SDEState]:
    a = np.float32(sched.alphas_cumprod[max(int(sched.timesteps[i]), 0)])
    alpha_t = float(np.sqrt(a))
    sigma_t = float(np.sqrt(np.float32(1.0) - a))
    xf = x.float()
    m_t = (xf - sigma_t * model_out.float()) / alpha_t
    x_next = (float(sched.A[i]) * xf + float(sched.B0[i]) * m_t
              + float(sched.B1[i]) * state.m0)
    if noise is not None:
        x_next = x_next + float(sched.N[i]) * noise.float()
    return x_next.to(x.dtype), SDEState(m0=m_t)
