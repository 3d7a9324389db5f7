"""The port's UniPC sampler against ``powerpaint_tpu/schedulers/unipc.py``:
the host coefficient tables, one step, and whole 20- and 45-step
trajectories driven by the same synthetic model on both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powerpaint_tpu.core.config import SchedulerConfig as JaxSchedulerConfig
from powerpaint_tpu.schedulers import unipc as jax_unipc
from powerpaint_tpu_torch.core.config import SchedulerConfig
from powerpaint_tpu_torch.schedulers import unipc

TABLES = ("pA", "pB", "pC", "cA", "cB", "cC", "cD", "use_corrector")


@pytest.mark.parametrize("steps,keep,kw", [
    (20, None, {}), (45, None, {}), (3, None, {}), (1, None, {}),
    (20, 12, {}), (25, None, dict(solver_type="bh1")),
    (20, None, dict(lower_order_final=False)), (10, None, dict(solver_order=1)),
])
def test_tables_match(steps, keep, kw):
    ours = unipc.make_unipc_schedule(SchedulerConfig(**kw), steps, keep)
    ref = jax_unipc.make_unipc_schedule(JaxSchedulerConfig(**kw), steps, keep)
    assert ours.num_steps == ref.num_steps
    np.testing.assert_array_equal(ours.timesteps, np.asarray(ref.timesteps))
    for name in TABLES:
        np.testing.assert_array_equal(getattr(ours, name),
                                      np.asarray(getattr(ref.coeffs, name)),
                                      err_msg=name)


def _model(x, i):
    """A deterministic stand-in for the UNet: the same numbers on both
    sides, depending on the sample and the step."""
    return 0.7 * np.tanh(x) + 0.05 * np.cos(0.3 * i + x)


@pytest.mark.parametrize("steps", [20, 45])
def test_trajectory_matches(steps):
    rng = np.random.RandomState(steps)
    x0 = rng.randn(2, 8, 8, 4).astype(np.float32)
    ours = unipc.make_unipc_schedule(SchedulerConfig(), steps)
    ref = jax_unipc.make_unipc_schedule(JaxSchedulerConfig(), steps)
    x_t, s_t = torch.from_numpy(x0), unipc.init_state(ours, x0.shape, "cpu")
    x_j = jnp.asarray(x0)
    s_j = jax_unipc.init_state(ref, x0.shape, jnp.float32)
    for i in range(steps):
        # both models see the JAX side's sample, so only one step's
        # difference is compared at a time, then the whole path
        eps = _model(np.asarray(x_j), i).astype(np.float32)
        x_j, s_j = jax_unipc.step(ref, s_j, jnp.asarray(eps), i, x_j)
        x_t, s_t = unipc.step(ours, s_t, torch.from_numpy(
            _model(x_t.numpy(), i).astype(np.float32)), i, x_t)
        np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), atol=1e-6,
                                   rtol=1e-6, err_msg=f"step {i}")
    assert np.isfinite(x_t.numpy()).all()
