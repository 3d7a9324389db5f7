"""The port's LoRA factors and LCM-LoRA distillation against the JAX
package's, on the CPU at the tiny ppt-v1 config in fp32.

- a JAX ``init_lora_tree`` carried across (``params_from_jax(..,
  "lora")``): the port's ``init_lora_tree`` targets the same modules with
  the same shapes, and ``apply_lora`` merges what the JAX one merges;
- the v1 distillation loss and every LoRA gradient, given the JAX loss's
  five draws (``split(key, 5)``: the two latents, the grid index, eps and
  the guidance), on a factor tree whose ``up`` is not zero (both factors
  get gradients): the loss within 1e-5 relative, each gradient within
  1e-4 of the largest (``test_torch_train.py`` says why);
- ``boundary_scalings`` and the coarse grid as the JAX package's.

One JAX compile: the distillation loss's ``jit(value_and_grad)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powerpaint_tpu.testing import tiny_v1_config as jax_tiny_v1_config
from powerpaint_tpu.train import data as jax_data
from powerpaint_tpu.train import distill as jax_distill
from powerpaint_tpu.train.lora import apply_lora as jax_apply_lora
from powerpaint_tpu.train.lora import init_lora_tree as jax_init_lora_tree
from powerpaint_tpu_torch.io.weights import build_models, params_from_jax
from powerpaint_tpu_torch.testing import tiny_v1_config
from powerpaint_tpu_torch.train import distill
from powerpaint_tpu_torch.train.lora import (
    apply_lora,
    init_lora_tree,
    lora_param_count,
    zero_lora_like,
)
from test_torch_train import (
    GRAD_ATOL,
    HW,
    jax_draws,
    random_stack,
    tokenizers,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are tiny, and the suite's parallel
    workers would otherwise oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _grad_mode_on():
    """Autograd on for each test: other test modules of the suite turn it
    off for the whole process when they are imported."""
    with torch.enable_grad():
        yield


def _torch_lora(lora_j):
    return {m: {k: torch.from_numpy(np.array(v)) for k, v in f.items()}
            for m, f in params_from_jax(jax.tree.map(np.asarray, lora_j),
                                        "lora").items()}


def test_lora_tree_carried_across():
    cfg = tiny_v1_config()
    trees, params = random_stack(cfg)
    lora_j = jax_init_lora_tree(trees["unet"], 4, jax.random.PRNGKey(5))
    carried = _torch_lora(lora_j)
    own = init_lora_tree(build_models(cfg)["unet"], 4,
                         torch.Generator().manual_seed(5))
    assert set(carried) == set(own)
    for name, f in own.items():
        for k in ("down", "up"):
            assert f[k].shape == carried[name][k].shape, (name, k)
        assert not f["up"].any()
    assert lora_param_count(own) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(lora_j))
    assert all(not t.any() for f in zero_lora_like(own).values()
               for t in f.values())

    # the merge, on factors whose up is not zero
    rng = np.random.RandomState(6)
    lora_j = jax.tree.map(lambda x: jnp.asarray(
        rng.randn(*x.shape).astype(np.float32) * 0.1), lora_j)
    want = params_from_jax(jax.tree.map(
        np.asarray, jax_apply_lora(trees["unet"], lora_j, scale=0.7)), "unet")
    got = apply_lora(params["unet"], _torch_lora(lora_j), scale=0.7)
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)


@pytest.fixture(scope="module")
def lcm():
    cfg = tiny_v1_config()
    trees, params = random_stack(cfg)
    _, jtok = tokenizers()
    batch = next(jax_data.batches(jax_data.SyntheticSource(hw=HW, seed=31),
                                  jtok, 2, version="ppt-v1", seed=32))
    rng = np.random.RandomState(7)
    lora_j = jax.tree.map(
        lambda x: jnp.asarray(rng.randn(*x.shape).astype(np.float32) * 0.05),
        jax_init_lora_tree(trees["unet"], 4, jax.random.PRNGKey(8)))
    key = jax.random.fold_in(jax.random.PRNGKey(2), 5)
    loss_j = jax_distill.make_lcm_distill_loss(
        jax_tiny_v1_config(), trees, dtype=jnp.float32)
    (loss, aux), grads = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(
        lora_j, batch, key)
    origin = cfg.scheduler.original_inference_steps
    draws = jax_draws(key, 2, HW, origin,
                      names=("lat", "mlat", "i", "eps", "w"))
    return dict(cfg=cfg, params=params, batch=batch, lora=_torch_lora(lora_j),
                draws=draws, loss=float(loss), gap=float(aux["consistency_gap"]),
                grads=grads)


def test_lcm_distill_loss_and_gradients_match_jax(lcm):
    loss_fn = distill.make_lcm_distill_loss(lcm["cfg"], lcm["params"])
    leaves = {m: {k: t.clone().requires_grad_(True) for k, t in f.items()}
              for m, f in lcm["lora"].items()}
    loss, metrics = loss_fn(leaves, lcm["batch"], lcm["draws"])
    np.testing.assert_allclose(float(loss), lcm["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(metrics["consistency_gap"]), lcm["gap"],
                               rtol=1e-5)
    flat = [(m, k, t) for m, f in leaves.items() for k, t in f.items()]
    got = torch.autograd.grad(loss, [t for _, _, t in flat])
    want = params_from_jax(jax.tree.map(np.asarray, lcm["grads"]), "lora")
    gmax = max(float(np.abs(v).max()) for f in want.values()
               for v in f.values())
    assert gmax > 0
    for (m, k, _), g in zip(flat, got):
        np.testing.assert_allclose(g.numpy(), want[m][k], rtol=0,
                                   atol=GRAD_ATOL * gmax, err_msg=f"{m}/{k}")


def test_boundary_scalings_and_grid_match_jax():
    cfg = tiny_v1_config()
    tok, jtok = tokenizers()
    assert np.array_equal(distill.uncond_ids(tok), jax_distill.uncond_ids(jtok))
    t = np.array([0, 19, 499, 999])
    for got, want in zip(
            distill.boundary_scalings(torch.from_numpy(t),
                                      cfg.scheduler.timestep_scaling),
            jax_distill.boundary_scalings(jnp.asarray(t),
                                          cfg.scheduler.timestep_scaling)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    grid = distill.coarse_grid(cfg)
    assert grid[0] == 19 and grid[-1] == 999 and len(grid) == 50
    x = np.random.RandomState(0).randn(2, 4, 4, 4).astype(np.float32)
    e = np.random.RandomState(1).randn(2, 4, 4, 4).astype(np.float32)
    acp = np.linspace(0.99, 0.01, 1000).astype(np.float32)
    tt, tp = np.array([999, 40]), np.array([979, 0])
    got = distill.ddim_solver_step(torch.from_numpy(x), torch.from_numpy(e),
                                   torch.from_numpy(acp), torch.from_numpy(tt),
                                   torch.from_numpy(tp))
    want = jax_distill.ddim_solver_step(x, e, jnp.asarray(acp), tt, tp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
