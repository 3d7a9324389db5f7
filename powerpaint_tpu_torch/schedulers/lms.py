"""LMS discrete sampler (linear multistep, order <= 4), in sigma space.

Adams-Bashforth on the probability-flow ODE in sigma space, where for
epsilon prediction the derivative is the model output:

    x_{i+1} = x_i + sum_k C[i, k] * d_{i-k},
    C[i, k] = integral over [s_i, s_{i+1}] of L_k(s) ds,

with L_k the Lagrange basis over the last ``order`` sigma points. The
basis polynomials have degree <= 3, so the integrals are exact on the host
through polynomial antiderivatives (a copy of the JAX package's
``make_lms_schedule``); a step is four multiply-adds over a history of
three derivatives.
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

ORDER = 4


@dataclasses.dataclass
class LMSState:
    d1: torch.Tensor  # the derivative history, newest first
    d2: torch.Tensor
    d3: torch.Tensor


@dataclasses.dataclass(frozen=True)
class LMSSchedule:
    config: SchedulerConfig
    timesteps: np.ndarray  # (S,)
    sigmas: np.ndarray  # (S+1,) fp32, sigmas[-1] = 0
    coeffs: np.ndarray  # (S, ORDER) fp32, the integrated Lagrange weights
    num_steps: int
    init_noise_sigma_val: float

    @property
    def init_noise_sigma(self) -> float:
        return self.init_noise_sigma_val


def _lagrange_integral(points: np.ndarray, k: int, a: float, b: float) -> float:
    """Exact integral over [a, b] of the k-th Lagrange basis polynomial
    through ``points`` (degree len(points) - 1 <= 3)."""
    others = np.delete(points, k)
    num = np.poly(others) if len(others) else np.array([1.0])
    den = np.prod(points[k] - others) if len(others) else 1.0
    anti = np.polyint(num / den)
    return float(np.polyval(anti, b) - np.polyval(anti, a))


def make_lms_schedule(cfg: SchedulerConfig, num_steps: int,
                      keep_steps: Optional[int] = None) -> LMSSchedule:
    acp = alphas_cumprod(cfg)
    ts = kept_timesteps(cfg, num_steps, keep_steps)
    S = len(ts)
    sig = np.sqrt((1.0 - acp[ts]) / acp[ts])
    sigmas = np.concatenate([sig, [0.0]])
    C = np.zeros((S, ORDER))
    for i in range(S):
        order = min(i + 1, ORDER)
        pts = np.array([sigmas[i - k] for k in range(order)])
        for k in range(order):
            C[i, k] = _lagrange_integral(pts, k, sigmas[i], sigmas[i + 1])
    return LMSSchedule(
        config=cfg, timesteps=ts, sigmas=sigmas.astype(np.float32),
        coeffs=C.astype(np.float32), num_steps=S,
        init_noise_sigma_val=float(np.sqrt(sigmas[0] ** 2 + 1.0)))


add_noise_at = sigma_add_noise_at
scale_model_input = sigma_scale_model_input


def init_state(sched: LMSSchedule, shape, device) -> LMSState:
    z = torch.zeros(shape, dtype=torch.float32, device=device)
    return LMSState(d1=z, d2=z, d3=z)


def step(sched: LMSSchedule, state: LMSState, model_out: torch.Tensor,
         i: int, x: torch.Tensor) -> Tuple[torch.Tensor, LMSState]:
    d0 = model_out.float()
    c = [float(v) for v in sched.coeffs[i]]
    x_next = (x.float() + c[0] * d0 + c[1] * state.d1 + c[2] * state.d2
              + c[3] * state.d3)
    return x_next.to(x.dtype), LMSState(d1=d0, d2=state.d1, d3=state.d2)
