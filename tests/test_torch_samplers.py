"""The port's sampler family against ``powerpaint_tpu/schedulers``.

- Tables: every host table of every registry sampler equals the JAX
  package's exactly, at 20 and 45 steps and 20 keeping 12 (LCM: 4, and 4
  keeping 2).
- Trajectories: the JAX module's loop and the port's, from one
  numpy-seeded x, driven by the constant-x0 epsilon model of
  ``tests/test_scheduler_exactness.py`` evaluated on each side's scaled
  input, and by that model plus a term that varies with x and the
  iteration (on the constant-x0 model every derivative along a path is
  the same, so a multistep history read in the wrong order would pass),
  with the same step noise injected into the stochastic samplers: within
  1e-5 for the VP samplers, 1e-4 for the sigma-space ones (their values
  reach about 15).
- Exactness: on that model the deterministic samplers land on the true
  trajectory; euler_a and LCM without step noise land on x0, and DPM++ 2M
  SDE contracts its residual by its A table.
- The registry's names and aliases resolve to the JAX package's modules.
- Port-only pipeline checks (no JAX compile): heun's 2S-1 UNet evaluations
  on ppt-v1, and the ControlNet gating table on heun's iteration axis.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powerpaint_tpu import schedulers as jax_registry
from powerpaint_tpu.core.config import SchedulerConfig as JaxSchedulerConfig
from powerpaint_tpu.schedulers import heun as jax_heun
from powerpaint_tpu_torch import schedulers
from powerpaint_tpu_torch.core.config import SchedulerConfig
from powerpaint_tpu_torch.schedulers.common import alphas_cumprod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are tiny, and the suite's parallel
    workers would otherwise oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


NAMES = schedulers.SCHEDULERS
SIGMA_SPACE = ("euler", "euler_a", "heun", "lms")
STOCHASTIC = ("euler_a", "dpm_sde", "lcm")
DETERMINISTIC = tuple(n for n in NAMES if n not in STOCHASTIC)
ACP = alphas_cumprod(SchedulerConfig())
C, K = 0.37, -1.21  # the constant x0 and the noise direction


def _cases():
    for name in NAMES:
        grid = ([(4, None), (4, 2)] if name == "lcm"
                else [(20, None), (45, None), (20, 12)])
        for steps, keep in grid:
            yield pytest.param(name, steps, keep,
                               id=f"{name}-{steps}" + (f"-keep{keep}" if keep else ""))


def _leaves(obj, prefix=""):
    """Every array-valued table of a schedule, by dotted name (a JAX
    ``alphas_cumprod_j`` is the port's ``alphas_cumprod``; UniPC's
    ``base.`` and ``coeffs.`` scopes are flattened)."""
    out = {}
    items = (obj._asdict().items() if hasattr(obj, "_asdict")
             else ((f.name, getattr(obj, f.name))
                   for f in dataclasses.fields(obj)))
    for name, value in items:
        if name == "config":
            continue
        name = name[:-2] if name.endswith("_j") else name
        if dataclasses.is_dataclass(value) or hasattr(value, "_asdict"):
            out.update(_leaves(value, prefix))
        elif not isinstance(value, (int, float)):
            out[prefix + name] = np.asarray(value)
    return out


@pytest.mark.parametrize("name,steps,keep", list(_cases()))
def test_tables_match_jax(name, steps, keep):
    _, make = schedulers.get(name)
    _, jax_make = jax_registry.get(name)
    ours = make(SchedulerConfig(), steps, keep_steps=keep)
    ref = jax_make(JaxSchedulerConfig(), steps, keep_steps=keep)
    assert ours.num_steps == ref.num_steps
    assert np.float32(ours.init_noise_sigma) == np.float32(ref.init_noise_sigma)
    want, got = _leaves(ref), _leaves(ours)
    assert set(want) <= set(got), sorted(set(want) - set(got))
    for key, table in want.items():
        np.testing.assert_array_equal(got[key], table, err_msg=key)
    np.testing.assert_array_equal(ours.timesteps, np.asarray(ref.timesteps))


@pytest.mark.parametrize("alias", sorted(schedulers.ALIASES) + ["Euler_A", "PLMS"])
def test_names_resolve_as_in_jax(alias):
    mod, _ = schedulers.get(alias)
    jax_mod, _ = jax_registry.get(alias)
    assert mod.__name__.rsplit(".", 1)[1] == jax_mod.__name__.rsplit(".", 1)[1]
    assert schedulers.is_stochastic(alias) == jax_registry.is_stochastic(alias)


def test_registry_lists_the_jax_names_and_refuses_others():
    assert schedulers.SCHEDULERS == jax_registry.SCHEDULERS
    with pytest.raises(ValueError, match="unknown scheduler"):
        schedulers.get("karras")
    with pytest.raises(ValueError, match="original_inference_steps"):
        schedulers.get("lcm")[1](SchedulerConfig(), 51)


def _sigma(sched, i):
    """The sigma the model is evaluated at in iteration i (sigma space)."""
    table = getattr(sched, "eval_sigmas", None)
    return float(np.asarray(sched.sigmas if table is None else table)[i])


def _model(name, sched, x_in, i, curved=False):
    """The constant-x0 epsilon model on the scaled input ``x_in`` (numpy):
    eps = (x - alpha_t C) / sigma_t in VP space, (x - C) / sigma in sigma
    space, where x is the sample the scaled input came from; ``curved``
    adds 0.1 sin(3 x_in + 0.7 i)."""
    if name in SIGMA_SPACE:
        s = _sigma(sched, i)
        eps = (x_in * np.sqrt(s * s + 1.0) - C) / s
    else:
        t = max(int(np.asarray(sched.timesteps)[i]), 0)
        eps = (x_in - np.sqrt(ACP[t]) * C) / np.sqrt(1.0 - ACP[t])
    if curved:
        eps = eps + 0.1 * np.sin(3.0 * x_in + 0.7 * i)
    return eps.astype(np.float32)


def _run_jax(name, sched, x, noises, curved=False):
    mod, _ = jax_registry.get(name)
    x = jnp.asarray(x)
    state = mod.init_state(sched, x.shape, x.dtype)
    path = []
    for i in range(sched.num_steps):
        eps = _model(name, sched, np.asarray(mod.scale_model_input(sched, x, i)),
                     i, curved)
        kw = {"noise": jnp.asarray(noises[i])} if name in STOCHASTIC else {}
        x, state = mod.step(sched, state, jnp.asarray(eps), jnp.int32(i), x, **kw)
        path.append(np.asarray(x))
    return path


def _run_port(name, sched, x, noises, curved=False):
    mod, _ = schedulers.get(name)
    x = torch.from_numpy(x)
    state = mod.init_state(sched, x.shape, "cpu")
    path = []
    for i in range(sched.num_steps):
        eps = _model(name, sched, mod.scale_model_input(sched, x, i).numpy(),
                     i, curved)
        kw = ({"noise": None if noises is None else torch.from_numpy(noises[i])}
              if name in STOCHASTIC else {})
        x, state = mod.step(sched, state, torch.from_numpy(eps), i, x, **kw)
        path.append(x.numpy())
    return path


def _start(name, sched):
    """A point on the true trajectory at the schedule's first iteration."""
    if name in SIGMA_SPACE:
        return C + _sigma(sched, 0) * K
    t = int(np.asarray(sched.timesteps)[0])
    return np.sqrt(ACP[t]) * C + np.sqrt(1.0 - ACP[t]) * K


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("keep", [None, 2], ids=["full", "strength"])
@pytest.mark.parametrize("curved", [False, True], ids=["constant_x0", "curved"])
def test_trajectory_matches_jax(name, keep, curved):
    steps = 4 if name == "lcm" else 20
    keep = None if keep is None else (2 if name == "lcm" else 12)
    ours = schedulers.get(name)[1](SchedulerConfig(), steps, keep_steps=keep)
    ref = jax_registry.get(name)[1](JaxSchedulerConfig(), steps, keep_steps=keep)
    rng = np.random.RandomState(len(name))
    x = (_start(name, ours) + 0.5 * rng.randn(2, 4, 4, 4)).astype(np.float32)
    noises = rng.randn(ours.num_steps, 2, 4, 4, 4).astype(np.float32)
    atol = 1e-4 if name in SIGMA_SPACE else 1e-5
    for i, (got, want) in enumerate(zip(_run_port(name, ours, x, noises, curved),
                                        _run_jax(name, ref, x, noises, curved))):
        np.testing.assert_allclose(got, want, atol=atol, rtol=0,
                                   err_msg=f"{name} iteration {i}")


@pytest.mark.parametrize("name", DETERMINISTIC)
@pytest.mark.parametrize("steps,keep", [(10, None), (10, 6)])
def test_deterministic_samplers_track_constant_x0(name, steps, keep):
    sched = schedulers.get(name)[1](SchedulerConfig(), steps, keep_steps=keep)
    x = np.full((1, 4, 4, 1), _start(name, sched), np.float32)
    path = _run_port(name, sched, x, None)
    final = path[-1]
    if name in SIGMA_SPACE:
        # the last step to sigma = 0 lands on C from any x, so the carry is
        # held to the trajectory after every iteration too
        after = getattr(sched, "blend_sigmas", getattr(sched, "sigmas", None))
        for i, xi in enumerate(path):
            np.testing.assert_allclose(xi, C + float(after[i + 1]) * K,
                                       rtol=2e-4, atol=1e-5,
                                       err_msg=f"{name} iteration {i}")
        want = C  # sigma reaches exactly 0
    else:  # t <= 0 is alphas_cumprod[0] (set_alpha_to_one=False)
        want = np.sqrt(ACP[0]) * C + np.sqrt(1.0 - ACP[0]) * K
    np.testing.assert_allclose(final, want, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("name", STOCHASTIC)
def test_stochastic_samplers_without_noise(name):
    """euler_a scales x - x0 by sigma_down / sigma and ends at sigma_down
    = 0; LCM's last step returns c_out x0 + c_skip x with c_skip < 1e-7;
    DPM++ 2M SDE keeps x - alpha x0 on its A table's contraction."""
    steps = 4 if name == "lcm" else 10
    sched = schedulers.get(name)[1](SchedulerConfig(), steps)
    x = np.full((1, 4, 4, 1), _start(name, sched), np.float32)
    path = _run_port(name, sched, x, None)
    if name != "dpm_sde":
        np.testing.assert_allclose(path[-1], C, rtol=1e-5, atol=1e-5)
        return
    ts = [int(t) for t in sched.timesteps] + [0]
    resid = float(x.flat[0]) - np.sqrt(ACP[ts[0]]) * C
    for i, xi in enumerate(path):
        resid *= float(sched.A[i])
        np.testing.assert_allclose(xi, np.sqrt(ACP[ts[i + 1]]) * C + resid,
                                   rtol=1e-4, atol=1e-6, err_msg=f"step {i}")


def test_heun_iteration_map_matches_jax():
    for s in (1, 4, 20):
        np.testing.assert_array_equal(schedulers.heun.iteration_step_map(s),
                                      jax_heun.iteration_step_map(s))


# ------------------------------------------------------------ pipelines


@pytest.fixture(scope="module")
def cn_pipe():
    from powerpaint_tpu_torch.io.weights import init_state
    from powerpaint_tpu_torch.pipelines.controlnet import ControlNetPipeline
    from powerpaint_tpu_torch.testing import tiny_v1_controlnet_config
    from powerpaint_tpu_torch.text.tokenizer import (
        HashTokenizer,
        TokenizerWrapper,
        add_task_tokens,
    )

    cfg = tiny_v1_controlnet_config()
    tok = TokenizerWrapper(HashTokenizer(994))
    add_task_tokens(tok)
    state = init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    return ControlNetPipeline(cfg, state, tok, dtype=torch.float32, device="cpu")


def _image_mask(hw=64):
    rng = np.random.RandomState(0)
    image = (rng.rand(hw, hw, 3) * 255).astype(np.uint8)
    mask = np.zeros((hw, hw), np.float32)
    mask[13:50, 10:45] = 1.0
    return image, mask


def test_heun_runs_two_evaluations_a_step(cn_pipe, monkeypatch):
    """ppt-v1 (the ControlNet pipeline without a control image) at heun: S
    user steps are 2S-1 UNet evaluations, and the noise draws are the
    three of a deterministic sampler."""
    calls, draws = [], []
    forward = cn_pipe.unet.forward
    monkeypatch.setattr(cn_pipe.unet, "forward",
                        lambda *a, **k: calls.append(1) or forward(*a, **k))
    draw = cn_pipe._draw_noise
    monkeypatch.setattr(cn_pipe, "_draw_noise",
                        lambda *a: draws.append(a[-1]) or draw(*a))
    image, mask = _image_mask()
    out = cn_pipe(image, mask, prompt="a dog", num_inference_steps=3,
                  scheduler="heun", seed=1)
    assert out.shape == (1, 64, 64, 3) and len(calls) == 5 and draws == [0]
    calls.clear()
    cn_pipe(image, mask, prompt="a dog", num_inference_steps=3,
            scheduler="euler_a", seed=1)
    assert len(calls) == 3 and draws == [0, 3]


@pytest.mark.parametrize("name,rows", [("heun", 5), ("pndm", 3), ("ddim", 3)])
def test_controlnet_gating_table_on_the_iteration_axis(cn_pipe, monkeypatch,
                                                       name, rows):
    """The table the ControlNet pipeline hands ``_generate``: each branch's
    per-step keeps (the JAX package's formula) read through heun's
    ``iteration_step_map``; pndm keeps one row a step (its extra
    iteration reads the last)."""
    seen = {}
    monkeypatch.setattr(cn_pipe, "_generate",
                        lambda *a, **k: seen.update(k) or torch.zeros(1, 1, 1, 1))
    image, mask = _image_mask()
    edges = np.zeros((64, 64, 3), np.uint8)
    cn_pipe(image, mask, edges, prompt="a dog", num_inference_steps=3,
            scheduler=name, controlnet_conditioning_scale=0.7,
            control_guidance_start=0.3, control_guidance_end=0.7)
    s = 3
    keeps = np.array([[(1.0 - float(i / s < 0.3 or (i + 1) / s > 0.7)) * 0.7]
                      for i in range(s)], np.float32)
    if name == "heun":
        keeps = keeps[jax_heun.iteration_step_map(s)]
    assert seen["scales"].shape == (rows, 1) and seen["scheduler"] == name
    np.testing.assert_array_equal(seen["scales"], keeps)
