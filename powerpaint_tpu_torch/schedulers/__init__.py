"""The sampler registry, with one interface for every sampler module:

    make(config, num_steps, keep_steps=None) -> schedule
    init_state(schedule, shape, device) -> state
    scale_model_input(schedule, x, i) -> x
    add_noise_at(schedule, x0, noise, i) -> x
    step(schedule, state, model_out, i, x[, noise=]) -> (x, state)
    schedule.timesteps / .num_steps (iterations, one UNet evaluation
    each) / .init_noise_sigma

A module with ``stochastic = True`` takes one fresh noise tensor per
iteration in ``step``; heun's ``iteration_step_map`` maps iterations to
user steps. ``get(name)`` takes the JAX package's names and aliases
(``powerpaint_tpu/schedulers/__init__.py``), the reference's
swap-any-scheduler surface.
"""

from __future__ import annotations

from typing import Callable, Tuple

from powerpaint_tpu_torch.schedulers import (
    ancestral,
    ddim,
    deis,
    dpm,
    euler,
    heun,
    lcm,
    lms,
    pndm,
    sde,
    unipc,
)
from powerpaint_tpu_torch.schedulers.common import make_schedule

SCHEDULERS = (
    "ddim", "pndm", "unipc", "dpm", "euler",
    "euler_a", "heun", "lms", "deis", "dpm_sde", "lcm",
)

_REGISTRY = {
    ("ddim",): (ddim, make_schedule),
    ("pndm", "plms"): (pndm, pndm.make_pndm_schedule),
    ("unipc",): (unipc, unipc.make_unipc_schedule),
    ("dpm", "dpm++", "dpmsolver", "dpmsolver++"): (dpm, dpm.make_dpm_schedule),
    ("euler",): (euler, euler.make_euler_schedule),
    ("euler_a", "euler_ancestral", "euler-ancestral"):
        (ancestral, ancestral.make_ancestral_schedule),
    ("heun",): (heun, heun.make_heun_schedule),
    ("lms",): (lms, lms.make_lms_schedule),
    ("deis",): (deis, deis.make_deis_schedule),
    ("dpm_sde", "dpm++sde", "sde-dpmsolver++", "dpm++_2m_sde"):
        (sde, sde.make_sde_schedule),
    ("lcm",): (lcm, lcm.make_lcm_schedule),
}
_BY_ALIAS = {alias: entry for names, entry in _REGISTRY.items()
             for alias in names}
ALIASES = tuple(_BY_ALIAS)


def get(name: str) -> Tuple[object, Callable]:
    """(module, make) of the sampler ``name`` or one of its aliases."""
    try:
        return _BY_ALIAS[name.lower()]
    except KeyError:
        raise ValueError(f"unknown scheduler {name!r}; one of "
                         f"{'/'.join(SCHEDULERS)}") from None


def is_stochastic(name: str) -> bool:
    """True if the sampler takes fresh noise every iteration."""
    mod, _ = get(name)
    return bool(getattr(mod, "stochastic", False))
