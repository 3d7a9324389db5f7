"""UniPC multistep sampler (predictor-corrector, bh1 / bh2, data
prediction), the ppt-v2 default.

As in the JAX package, the whole order schedule (the warm-up ramp,
``lower_order_final``) and every R / b solve are computed on the host in
float64 into per-step fp32 coefficient tables (``make_unipc_schedule``, a
copy of ``powerpaint_tpu/schedulers/unipc.py``'s numpy logic); a step is
then a few multiply-adds of tensors with host scalars:

  corrector (i >= 1): x = cA*last - cB*m0 - cC*(m1 - m0) - cD*(m_t - m0)
  predictor:          x_next = pA*x - pB*m_t - pC*(m0 - m_t)

where m_t is the data prediction at step i, m0 and m1 the two before it,
and ``last`` the sample before the latest predictor step. Solver orders 1
and 2; prediction types epsilon / v_prediction / sample.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from powerpaint_tpu_torch.core.config import SchedulerConfig
from powerpaint_tpu_torch.schedulers.common import (
    DiffusionSchedule,
    alphas_cumprod,
    make_schedule,
)


@dataclasses.dataclass(frozen=True)
class UniPCSchedule:
    base: DiffusionSchedule
    # per-step (S,) fp32 tables; see the module docstring
    pA: np.ndarray
    pB: np.ndarray
    pC: np.ndarray
    cA: np.ndarray
    cB: np.ndarray
    cC: np.ndarray
    cD: np.ndarray
    use_corrector: np.ndarray

    @property
    def timesteps(self) -> np.ndarray:
        return self.base.timesteps

    @property
    def num_steps(self) -> int:
        return self.base.num_steps

    @property
    def init_noise_sigma(self) -> float:
        return 1.0


@dataclasses.dataclass
class UniPCState:
    m0: torch.Tensor  # data prediction at the latest step
    m1: torch.Tensor  # the one before
    last_sample: torch.Tensor  # the sample before the latest predictor step


def _phi_terms(hh: float, solver_type: str):
    """(h_phi_1, b1, b2, B_h) of the bh family."""
    h_phi_1 = np.expm1(hh)
    if solver_type == "bh1":
        B_h = hh
    elif solver_type == "bh2":
        B_h = np.expm1(hh)
    else:
        raise ValueError(solver_type)
    h_phi_k1 = h_phi_1 / hh - 1.0
    b1 = h_phi_k1 * 1.0 / B_h
    h_phi_k2 = h_phi_k1 / hh - 0.5
    b2 = h_phi_k2 * 2.0 / B_h
    return h_phi_1, b1, b2, B_h


def make_unipc_schedule(cfg: SchedulerConfig, num_steps: int,
                        keep_steps: Optional[int] = None) -> UniPCSchedule:
    """Every per-step coefficient, on the host in float64. ``keep_steps``
    keeps the last steps (strength < 1), the warm-up re-primed there."""
    base = make_schedule(cfg, num_steps, keep_steps)
    acp = alphas_cumprod(cfg)
    ts = base.timesteps
    S = len(ts)
    order = min(cfg.solver_order, 2)

    alpha = np.sqrt(acp)
    sigma = np.sqrt(1.0 - acp)
    lam = np.log(alpha) - np.log(sigma)

    def lam_at(t):
        return lam[t] if t >= 0 else lam[0]

    def boundary(t):  # (alpha, sigma, lambda), t < 0 -> t = 0
        t = max(int(t), 0)
        return alpha[t], sigma[t], lam[t]

    def order_p(i):  # predictor order at step i: warm-up, lower_order_final
        o = order
        if cfg.lower_order_final:
            o = min(o, S - i)
        return max(1, min(o, i + 1))

    tab = {k: np.zeros(S) for k in ("pA", "pB", "pC", "cA", "cB", "cC", "cD",
                                     "use_corrector")}
    for i in range(S):
        # predictor t_i -> t_{i+1} (the last step goes to t = 0)
        t_s0 = int(ts[i])
        t_t = int(ts[i + 1]) if i + 1 < S else 0
        a_t, s_t, l_t = boundary(t_t)
        a_s0, s_s0, l_s0 = boundary(t_s0)
        h = l_t - l_s0
        h_phi_1, b1, b2, B_h = _phi_terms(-h, cfg.solver_type)
        tab["pA"][i] = s_t / s_s0
        tab["pB"][i] = a_t * h_phi_1
        if order_p(i) >= 2:
            r1 = (lam_at(int(ts[i - 1])) - l_s0) / h
            tab["pC"][i] = a_t * B_h * 0.5 / r1  # diffusers' order-2 weight

        # corrector at step i >= 1: t_{i-1} -> t_i with the fresh model
        # output, at the predictor order used at step i - 1
        if i >= 1:
            tab["use_corrector"][i] = 1.0
            t_s0c = int(ts[i - 1])
            a_t, s_t, l_t = boundary(int(ts[i]))
            a_s0, s_s0, l_s0 = boundary(t_s0c)
            h = l_t - l_s0
            h_phi_1, b1, b2, B_h = _phi_terms(-h, cfg.solver_type)
            tab["cA"][i] = s_t / s_s0
            tab["cB"][i] = a_t * h_phi_1
            if order_p(i - 1) == 1:
                tab["cD"][i] = a_t * B_h * 0.5  # diffusers' order-1 weight
            else:
                t_s1 = int(ts[i - 2]) if i >= 2 else int(ts[0])
                r1 = (lam_at(t_s1) - l_s0) / h
                rhos = np.linalg.solve(np.array([[1.0, 1.0], [r1, 1.0]]),
                                       np.array([b1, b2]))
                tab["cC"][i] = a_t * B_h * rhos[0] / r1
                tab["cD"][i] = a_t * B_h * rhos[1]

    return UniPCSchedule(base=base, **{k: v.astype(np.float32)
                                       for k, v in tab.items()})


def init_state(sched: UniPCSchedule, shape, device) -> UniPCState:
    z = torch.zeros(shape, dtype=torch.float32, device=device)
    return UniPCState(m0=z, m1=z, last_sample=z)


def scale_model_input(sched: UniPCSchedule, x: torch.Tensor,
                      i: int) -> torch.Tensor:
    return x


def _to_x0(sched: UniPCSchedule, model_out: torch.Tensor, x: torch.Tensor,
           t: int) -> torch.Tensor:
    a = torch.tensor(float(sched.base.alphas_cumprod[max(t, 0)]),
                     dtype=torch.float32)
    alpha_t, sigma_t = torch.sqrt(a), torch.sqrt(1.0 - a)
    p = sched.base.config.prediction_type
    x = x.float()
    model_out = model_out.float()
    if p == "epsilon":
        return (x - sigma_t * model_out) / alpha_t
    if p == "sample":
        return model_out
    if p == "v_prediction":
        return alpha_t * x - sigma_t * model_out
    raise ValueError(p)


def step(sched: UniPCSchedule, state: UniPCState, model_out: torch.Tensor,
         i: int, x: torch.Tensor) -> Tuple[torch.Tensor, UniPCState]:
    """One step at index i: the corrector (i > 0), then the predictor."""
    c = lambda name: float(getattr(sched, name)[i])  # noqa: E731
    xf = x.float()
    m_t = _to_x0(sched, model_out, xf, int(sched.timesteps[i]))
    if sched.use_corrector[i] > 0:
        xf = (c("cA") * state.last_sample - c("cB") * state.m0
              - c("cC") * (state.m1 - state.m0) - c("cD") * (m_t - state.m0))
    x_next = c("pA") * xf - c("pB") * m_t - c("pC") * (state.m0 - m_t)
    return x_next.to(x.dtype), UniPCState(m0=m_t, m1=state.m0, last_sample=xf)
