"""PNDM (the PLMS variant, ``skip_prk_steps=True``), the sampler the SD
inpainting checkpoint ships with.

Linear-multistep Adams-Bashforth on the epsilon trajectory with a warm-up
quirk: the second-to-last train timestep of the ascending grid is visited
twice, so S user steps run S+1 model evaluations, and iteration 1 restarts
from iteration 0's sample with an averaged epsilon. Every index-dependent
number (the visit sequence, the multistep weights, the transition
coefficients) is a host table of S+1 entries, copied from the JAX
package's ``make_pndm_schedule``; a step is a few multiply-adds.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from powerpaint_tpu_torch.core.config import SchedulerConfig
from powerpaint_tpu_torch.schedulers.common import (
    alphas_cumprod,
    kept_timesteps,
    vp_add_noise_at,
)


class PNDMCoeffs(NamedTuple):
    sample_coeff: np.ndarray  # (S+1,)
    eps_coeff: np.ndarray  # (S+1,) -(a_prev - a_t) / denom
    comb: np.ndarray  # (S+1, 4) weights over [m_t, e1, e2, e3]
    push: np.ndarray  # (S+1,) 1: m_t enters the history
    use_cur: np.ndarray  # (S+1,) 1: integrate from the saved step-0 sample


@dataclasses.dataclass
class PNDMState:
    ets: List[torch.Tensor]  # newest-first epsilon history, 3 entries
    cur_sample: torch.Tensor


@dataclasses.dataclass(frozen=True)
class PNDMSchedule:
    config: SchedulerConfig
    alphas_cumprod: np.ndarray  # (T,) fp32
    timesteps: np.ndarray  # (S+1,) the PLMS visit sequence
    coeffs: PNDMCoeffs
    num_steps: int  # S+1 iterations

    @property
    def init_noise_sigma(self) -> float:
        return 1.0


def make_pndm_schedule(cfg: SchedulerConfig, num_steps: int,
                       keep_steps: Optional[int] = None) -> PNDMSchedule:
    """``keep_steps`` keeps the last (lowest-t) steps for strength < 1,
    with the PLMS warm-up re-primed at the truncated start."""
    acp = alphas_cumprod(cfg)
    ratio = cfg.num_train_timesteps // num_steps
    asc = kept_timesteps(cfg, num_steps, keep_steps)[::-1].copy()  # ascending
    # the PLMS visit sequence: [..., :-1] ++ [-2:-1] ++ [-1:], reversed
    visits = np.concatenate([asc[:-1], asc[-2:-1], asc[-1:]])[::-1].copy()
    n = len(visits)
    final_alpha = 1.0 if cfg.set_alpha_to_one else float(acp[0])

    def a_at(t):
        return float(acp[t]) if t >= 0 else final_alpha

    sample_coeff = np.zeros(n)
    eps_coeff = np.zeros(n)
    comb = np.zeros((n, 4))
    push = np.zeros(n)
    use_cur = np.zeros(n)
    for i in range(n):
        t = int(visits[i])
        prev_t = t - ratio
        if i == 1:
            # reuse step 0's sample; integrate t + ratio -> t
            prev_t = t
            t = t + ratio
            use_cur[i] = 1.0
            comb[i] = [0.5, 0.5, 0.0, 0.0]
        else:
            push[i] = 1.0
            if i == 0:
                comb[i] = [1.0, 0.0, 0.0, 0.0]
            elif i == 2:
                comb[i] = [1.5, -0.5, 0.0, 0.0]
            elif i == 3:
                comb[i] = [23 / 12, -16 / 12, 5 / 12, 0.0]
            else:
                comb[i] = [55 / 24, -59 / 24, 37 / 24, -9 / 24]
        a_t = a_at(t)
        a_prev = a_at(prev_t)
        b_t = 1.0 - a_t
        b_prev = 1.0 - a_prev
        sample_coeff[i] = (a_prev / a_t) ** 0.5
        denom = a_t * b_prev ** 0.5 + (a_t * b_t * a_prev) ** 0.5
        eps_coeff[i] = -(a_prev - a_t) / denom

    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return PNDMSchedule(
        config=cfg, alphas_cumprod=f32(acp), timesteps=visits,
        coeffs=PNDMCoeffs(f32(sample_coeff), f32(eps_coeff), f32(comb),
                          f32(push), f32(use_cur)),
        num_steps=n)


add_noise_at = vp_add_noise_at


def init_state(sched: PNDMSchedule, shape, device) -> PNDMState:
    z = torch.zeros(shape, dtype=torch.float32, device=device)
    return PNDMState(ets=[z, z, z], cur_sample=z)


def scale_model_input(sched: PNDMSchedule, x: torch.Tensor,
                      i: int) -> torch.Tensor:
    return x


def step(sched: PNDMSchedule, state: PNDMState, model_out: torch.Tensor,
         i: int, x: torch.Tensor) -> Tuple[torch.Tensor, PNDMState]:
    c = sched.coeffs
    m = model_out.float()
    xf = x.float()
    # step 0 saves its sample; step 1 restarts from it
    cur = xf if i == 0 else state.cur_sample
    base = cur if c.use_cur[i] > 0 else xf
    w = [float(v) for v in c.comb[i]]
    e1, e2, e3 = state.ets
    eps = w[0] * m + w[1] * e1 + w[2] * e2 + w[3] * e3
    x_prev = float(c.sample_coeff[i]) * base + float(c.eps_coeff[i]) * eps
    ets = [m, e1, e2] if c.push[i] > 0 else state.ets
    return x_prev.to(x.dtype), PNDMState(ets=ets, cur_sample=cur)
