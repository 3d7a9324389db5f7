"""The port's DDIM schedule and step against ``powerpaint_tpu.schedulers``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powerpaint_tpu.core.config import SchedulerConfig as JaxSchedulerConfig
from powerpaint_tpu.schedulers import common as jax_common
from powerpaint_tpu.schedulers import ddim as jax_ddim
from powerpaint_tpu_torch.core.config import SchedulerConfig
from powerpaint_tpu_torch.schedulers import ddim
from powerpaint_tpu_torch.schedulers.common import make_schedule


@pytest.mark.parametrize("steps,keep", [(20, None), (45, None), (3, None),
                                        (20, 12), (50, 30)])
def test_ddim_tables_match(steps, keep):
    ours = make_schedule(SchedulerConfig(), steps, keep_steps=keep)
    ref = jax_common.make_schedule(JaxSchedulerConfig(), steps, keep_steps=keep)
    assert ours.num_steps == ref.num_steps
    np.testing.assert_array_equal(ours.timesteps, np.asarray(ref.timesteps))
    np.testing.assert_array_equal(ours.prev_timesteps,
                                  np.asarray(ref.prev_timesteps))
    np.testing.assert_array_equal(ours.alphas_cumprod,
                                  np.asarray(ref.alphas_cumprod))
    assert np.float32(ours.final_alpha_cumprod) == np.float32(
        ref.final_alpha_cumprod)
    # the SD1.5 settings: leading spacing, steps_offset 1
    if steps == 20 and keep is None:
        assert ours.timesteps[0] == 951 and ours.timesteps[-1] == 1


@pytest.mark.parametrize("i,eta", [(0, 0.0), (7, 0.0), (19, 0.0), (5, 0.5),
                                   (19, 1.0)])
def test_ddim_step_matches(i, eta):
    rng = np.random.RandomState(i)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    eps = rng.randn(2, 8, 8, 4).astype(np.float32)
    noise = rng.randn(2, 8, 8, 4).astype(np.float32)
    ours = make_schedule(SchedulerConfig(), 20)
    ref = jax_common.make_schedule(JaxSchedulerConfig(), 20)
    want, _ = jax_ddim.step(ref, jax_ddim.init_state(ref, x.shape, x.dtype),
                            jnp.asarray(eps), i, jnp.asarray(x), eta=eta,
                            noise=jnp.asarray(noise))
    got, _ = ddim.step(ours, ddim.init_state(ours, x.shape, "cpu"),
                       torch.from_numpy(eps), i, torch.from_numpy(x),
                       eta=eta, noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("i", [0, 5, 11])
def test_add_noise_at_matches(i):
    rng = np.random.RandomState(i)
    x0 = rng.randn(1, 8, 8, 4).astype(np.float32)
    noise = rng.randn(1, 8, 8, 4).astype(np.float32)
    ours = make_schedule(SchedulerConfig(), 20, keep_steps=12)
    ref = jax_common.make_schedule(JaxSchedulerConfig(), 20, keep_steps=12)
    want = jax_ddim.add_noise_at(ref, jnp.asarray(x0), jnp.asarray(noise), i)
    got = ddim.add_noise_at(ours, torch.from_numpy(x0), torch.from_numpy(noise), i)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
