"""DEIS multistep sampler (the log-rho exponential integrator, order 2).

With rho = sigma / alpha the probability-flow ODE is d(x / alpha) / d rho =
eps(x, t), so each step integrates a polynomial extrapolation of eps in
log rho:

    x_{t+1} = alpha_{t+1} * (x_t / alpha_t + c0_i * eps_i + c1_i * eps_{i-1}),

the coefficients the closed-form integrals of the log-space Lagrange basis
on the host (a copy of the JAX package's ``make_deis_schedule``). The first
step and, with ``lower_order_final``, the last are first order, where the
update is DDIM's.
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


@dataclasses.dataclass
class DEISState:
    e1: torch.Tensor  # the previous eps


@dataclasses.dataclass(frozen=True)
class DEISSchedule:
    config: SchedulerConfig
    timesteps: np.ndarray
    alpha_cur: np.ndarray  # (S,) alpha at t_i
    alpha_next: np.ndarray  # (S,) alpha at t_{i+1} (t < 0: the final acp)
    c0: np.ndarray  # (S,) weight on the current eps
    c1: np.ndarray  # (S,) weight on the previous eps
    alphas_cumprod: np.ndarray  # for add_noise_at
    num_steps: int

    @property
    def init_noise_sigma(self) -> float:
        return 1.0


def _ind(x: float, b: float, c: float) -> float:
    """Antiderivative at x of the log-space Lagrange basis
    (log t - log c) / (log b - log c): 1 at t = b, 0 at t = c."""
    return x * (np.log(x) - np.log(c) - 1.0) / (np.log(b) - np.log(c))


def make_deis_schedule(cfg: SchedulerConfig, num_steps: int,
                       keep_steps: Optional[int] = None) -> DEISSchedule:
    acp = alphas_cumprod(cfg)
    ts = kept_timesteps(cfg, num_steps, keep_steps)
    S = len(ts)
    final = 1.0 if cfg.set_alpha_to_one else float(acp[0])

    def avals(t):
        a = final if t < 0 else float(acp[int(t)])
        alpha = np.sqrt(a)
        return alpha, np.sqrt(1.0 - a) / max(alpha, 1e-12)

    a_cur, a_next, c0, c1 = (np.zeros(S) for _ in range(4))
    for i in range(S):
        t_t = int(ts[i + 1]) if i + 1 < S else -1
        al_s, rho_s = avals(int(ts[i]))
        al_t, rho_t = avals(t_t)
        a_cur[i], a_next[i] = al_s, al_t
        first_order = i == 0 or (cfg.lower_order_final and i == S - 1)
        # rho_t = 0 at the clean end makes log(rho_t) singular in the
        # second-order basis: first order there too
        if not first_order and rho_t <= 0:
            first_order = True
        if first_order:
            c0[i], c1[i] = rho_t - rho_s, 0.0
        else:
            _, rho_s1 = avals(int(ts[i - 1]))
            c0[i] = _ind(rho_t, rho_s, rho_s1) - _ind(rho_s, rho_s, rho_s1)
            c1[i] = _ind(rho_t, rho_s1, rho_s) - _ind(rho_s, rho_s1, rho_s)

    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return DEISSchedule(config=cfg, timesteps=ts, alpha_cur=f32(a_cur),
                        alpha_next=f32(a_next), c0=f32(c0), c1=f32(c1),
                        alphas_cumprod=f32(acp), num_steps=S)


add_noise_at = vp_add_noise_at


def init_state(sched: DEISSchedule, shape, device) -> DEISState:
    return DEISState(e1=torch.zeros(shape, dtype=torch.float32, device=device))


def scale_model_input(sched: DEISSchedule, x: torch.Tensor,
                      i: int) -> torch.Tensor:
    return x


def step(sched: DEISSchedule, state: DEISState, model_out: torch.Tensor,
         i: int, x: torch.Tensor) -> Tuple[torch.Tensor, DEISState]:
    e0 = model_out.float()
    x_next = float(sched.alpha_next[i]) * (
        x.float() / float(sched.alpha_cur[i]) + float(sched.c0[i]) * e0
        + float(sched.c1[i]) * state.e1)
    return x_next.to(x.dtype), DEISState(e1=e0)
