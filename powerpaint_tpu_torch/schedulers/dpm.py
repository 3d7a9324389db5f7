"""DPM-Solver++ (2M, multistep, data prediction).

Second-order multistep on lambda = log(alpha / sigma):

  x_{i+1} = A_i * x - B_i * D,   D = c0_i * m_t + c1_i * m_{i-1}

with A the sigma ratio, B = alpha_{t+1} * expm1(-h) and (c0, c1) =
(1 + 1/(2r), -1/(2r)), r = h_{i-1} / h_i; the first step and, with
``lower_order_final``, the last are first order. Every coefficient is a
host table built in float64 (a copy of the JAX package's
``make_dpm_schedule``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from powerpaint_tpu_torch.core.config import SchedulerConfig
from powerpaint_tpu_torch.schedulers.common import (
    alphas_cumprod,
    kept_timesteps,
    vp_add_noise_at,
)


class DPMCoeffs(NamedTuple):
    A: np.ndarray  # sigma ratio
    B: np.ndarray  # alpha_{t+1} * expm1(-h)
    c0: np.ndarray  # weight on the newest x0 prediction
    c1: np.ndarray  # weight on the one before


@dataclasses.dataclass
class DPMState:
    m0: torch.Tensor  # the previous x0 prediction


@dataclasses.dataclass(frozen=True)
class DPMSchedule:
    config: SchedulerConfig
    alphas_cumprod: np.ndarray
    timesteps: np.ndarray
    coeffs: DPMCoeffs
    num_steps: int

    @property
    def init_noise_sigma(self) -> float:
        return 1.0


def make_dpm_schedule(cfg: SchedulerConfig, num_steps: int,
                      keep_steps: Optional[int] = None) -> DPMSchedule:
    """``keep_steps`` keeps the last steps for strength < 1; the first-order
    warm-up re-primes at the truncated start."""
    acp = alphas_cumprod(cfg)
    ts = kept_timesteps(cfg, num_steps, keep_steps)
    S = len(ts)
    alpha = np.sqrt(acp)
    sigma = np.sqrt(1.0 - acp)
    lam = np.log(alpha) - np.log(sigma)

    def bnd(t):
        t = max(int(t), 0)
        return alpha[t], sigma[t], lam[t]

    A, B, c0, c1 = (np.zeros(S) for _ in range(4))
    for i in range(S):
        t_t = int(ts[i + 1]) if i + 1 < S else 0
        a_t, s_t, l_t = bnd(t_t)
        a_s, s_s, l_s = bnd(int(ts[i]))
        h = l_t - l_s
        A[i] = s_t / s_s
        B[i] = a_t * np.expm1(-h)
        if i == 0 or (cfg.lower_order_final and i == S - 1):
            c0[i], c1[i] = 1.0, 0.0
        else:
            r = (l_s - bnd(int(ts[i - 1]))[2]) / h
            c0[i] = 1.0 + 1.0 / (2.0 * r)
            c1[i] = -1.0 / (2.0 * r)

    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return DPMSchedule(config=cfg, alphas_cumprod=f32(acp), timesteps=ts,
                       coeffs=DPMCoeffs(f32(A), f32(B), f32(c0), f32(c1)),
                       num_steps=S)


add_noise_at = vp_add_noise_at


def init_state(sched: DPMSchedule, shape, device) -> DPMState:
    return DPMState(m0=torch.zeros(shape, dtype=torch.float32, device=device))


def scale_model_input(sched: DPMSchedule, x: torch.Tensor,
                      i: int) -> torch.Tensor:
    return x


def step(sched: DPMSchedule, state: DPMState, model_out: torch.Tensor,
         i: int, x: torch.Tensor) -> Tuple[torch.Tensor, DPMState]:
    c = sched.coeffs
    a = np.float32(sched.alphas_cumprod[max(int(sched.timesteps[i]), 0)])
    alpha_t = float(np.sqrt(a))
    sigma_t = float(np.sqrt(np.float32(1.0) - a))
    xf = x.float()
    m_t = (xf - sigma_t * model_out.float()) / alpha_t  # x0 prediction
    d = float(c.c0[i]) * m_t + float(c.c1[i]) * state.m0
    x_next = float(c.A[i]) * xf - float(c.B[i]) * d
    return x_next.to(x.dtype), DPMState(m0=m_t)
