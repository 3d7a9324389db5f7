"""Heun discrete sampler (the second-order Karras predictor-corrector), in
sigma space.

Heun needs two model evaluations a step. As in the JAX package, the
predictor and corrector are interleaved into one flat iteration axis, so
the pipeline's loop stays one evaluation an iteration: S user steps run
2S-1 iterations. Each step from sigma_j to sigma_{j+1} > 0 runs a
predictor (Euler, evaluated at sigma_j), then a corrector (the trapezoid,
evaluated at sigma_{j+1}); the last step, to sigma = 0, is plain Euler.
``iteration_step_map`` gives the user step of each iteration, with which
the pipelines expand their per-step gating tables. A copy of the JAX
package's ``make_heun_schedule``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from powerpaint_tpu_torch.core.config import SchedulerConfig
from powerpaint_tpu_torch.schedulers.common import alphas_cumprod, kept_timesteps


@dataclasses.dataclass
class HeunState:
    anchor: torch.Tensor  # x at the start of the current second-order step
    d1: torch.Tensor  # the predictor's derivative


@dataclasses.dataclass(frozen=True)
class HeunSchedule:
    config: SchedulerConfig
    timesteps: np.ndarray  # (R,) the timestep evaluated at each iteration
    eval_sigmas: np.ndarray  # (R,) fp32, the sigma evaluated at
    dts: np.ndarray  # (R,) fp32, the sigma increment of the owning step
    is_pred: np.ndarray  # (R,) fp32, 1: predictor or the final Euler step
    blend_sigmas: np.ndarray  # (R+1,) fp32, the sigma before iteration i
    num_steps: int  # R = 2S - 1 iterations
    init_noise_sigma_val: float

    @property
    def init_noise_sigma(self) -> float:
        return self.init_noise_sigma_val


def make_heun_schedule(cfg: SchedulerConfig, num_steps: int,
                       keep_steps: Optional[int] = None) -> HeunSchedule:
    acp = alphas_cumprod(cfg)
    ts = kept_timesteps(cfg, num_steps, keep_steps)
    S = len(ts)
    sig = np.sqrt((1.0 - acp[ts]) / acp[ts])
    sigmas = np.concatenate([sig, [0.0]])  # sigmas[S] = 0

    R = 2 * S - 1
    t_it = np.zeros(R, np.int64)
    ev, dts, isp = np.zeros(R), np.zeros(R), np.zeros(R)
    blend = np.zeros(R + 1)
    blend[0] = sigmas[0]
    for j in range(S - 1):  # second-order steps sigma_j -> sigma_{j+1} > 0
        dt = sigmas[j + 1] - sigmas[j]
        rp, rc = 2 * j, 2 * j + 1
        t_it[rp], ev[rp], dts[rp], isp[rp] = ts[j], sigmas[j], dt, 1.0
        t_it[rc], ev[rc], dts[rc], isp[rc] = ts[j + 1], sigmas[j + 1], dt, 0.0
        blend[rp + 1] = sigmas[j + 1]
        blend[rc + 1] = sigmas[j + 1]
    # the final Euler step to sigma = 0
    t_it[R - 1], ev[R - 1] = ts[S - 1], sigmas[S - 1]
    dts[R - 1], isp[R - 1] = -sigmas[S - 1], 1.0
    blend[R] = 0.0

    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return HeunSchedule(
        config=cfg, timesteps=t_it, eval_sigmas=f32(ev), dts=f32(dts),
        is_pred=f32(isp), blend_sigmas=f32(blend), num_steps=R,
        init_noise_sigma_val=float(np.sqrt(sigmas[0] ** 2 + 1.0)))


def iteration_step_map(num_user_steps: int) -> np.ndarray:
    """Iteration index -> its user step: the rows of a per-user-step gating
    table (a ControlNet or BrushNet window) for each iteration."""
    S = num_user_steps
    return np.minimum(np.arange(2 * S - 1) // 2, S - 1)


def add_noise_at(sched: HeunSchedule, x0: torch.Tensor, noise: torch.Tensor,
                 i: int) -> torch.Tensor:
    s = float(sched.blend_sigmas[min(max(i, 0), sched.num_steps)])
    return (x0.float() + s * noise.float()).to(x0.dtype)


def init_state(sched: HeunSchedule, shape, device) -> HeunState:
    z = torch.zeros(shape, dtype=torch.float32, device=device)
    return HeunState(anchor=z, d1=z)


def scale_model_input(sched: HeunSchedule, x: torch.Tensor,
                      i: int) -> torch.Tensor:
    s = np.float32(sched.eval_sigmas[i])
    return (x.float() / float(np.sqrt(s * s + np.float32(1.0)))).to(x.dtype)


def step(sched: HeunSchedule, state: HeunState, model_out: torch.Tensor,
         i: int, x: torch.Tensor) -> Tuple[torch.Tensor, HeunState]:
    d = model_out.float()
    xf = x.float()
    dt = float(sched.dts[i])
    if sched.is_pred[i] > 0:  # Euler predictor: x is the step's anchor
        return (xf + dt * d).to(x.dtype), HeunState(anchor=xf, d1=d)
    # the trapezoid corrector
    x_next = state.anchor + dt * 0.5 * (state.d1 + d)
    return x_next.to(x.dtype), state
