"""The port's v2 (BrushNet-branch) training against the JAX package's, on
the CPU at the tiny ppt-v2 config in fp32: the v2 loss and every gradient
leaf given the JAX draws (the frozen base UNet and plain text encoder get
gradients too: the JAX step's ``grad_norm`` takes them), within the bounds
``test_torch_train.py`` states; one optimizer step with ``v2`` labels
against the JAX package's ``make_optimizer``, the base UNet, plain text
encoder and VAE bitwise unchanged.

One JAX compile: the v2 loss's ``jit(value_and_grad)`` (about 75 s here:
two UNets' backward; nothing else shares this file).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from powerpaint_tpu.testing import tiny_v2_config as jax_tiny_v2_config
from powerpaint_tpu.train import data as jax_data
from powerpaint_tpu.train.loss import make_v2_loss as jax_make_v2_loss
from powerpaint_tpu.train.step import make_optimizer
from powerpaint_tpu.train.step import trainable_mask as jax_trainable_mask
from powerpaint_tpu_torch.testing import tiny_v2_config
from powerpaint_tpu_torch.train.loss import make_v2_loss
from powerpaint_tpu_torch.train.step import (
    AdamW,
    flatten,
    init_train_state,
    make_train_step,
    trainable_mask,
)
from test_torch_train import (
    HW,
    LR,
    assert_grads_match,
    assert_params_match,
    jax_draws,
    port_grads,
    port_params,
    random_stack,
    tokenizers,
)

V2_FAMILIES = ("unet", "text_encoder", "brushnet", "text_encoder_brushnet")


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


@pytest.fixture(scope="module")
def v2():
    cfg = tiny_v2_config()
    trees, params = random_stack(cfg)
    _, jtok = tokenizers()
    batch = next(jax_data.batches(jax_data.SyntheticSource(hw=HW, seed=21),
                                  jtok, 2, version="ppt-v2", seed=22))
    key = jax.random.fold_in(jax.random.PRNGKey(1), 3)
    vg = jax.jit(jax.value_and_grad(
        jax_make_v2_loss(jax_tiny_v2_config(), dtype=jnp.float32),
        has_aux=True))
    (loss, _), grads = vg(trees, batch, key)
    draws = jax_draws(key, 2, HW, cfg.scheduler.num_train_timesteps)
    return dict(cfg=cfg, trees=trees, params=params, batch=batch,
                draws=draws, loss=float(loss), grads=grads)


def test_v2_loss_and_every_gradient_match_jax(v2):
    loss, _, grads = port_grads(make_v2_loss(v2["cfg"]), v2["params"],
                                v2["batch"], v2["draws"], V2_FAMILIES)
    np.testing.assert_allclose(float(loss), v2["loss"], rtol=1e-5)
    assert_grads_match(grads, v2["grads"], V2_FAMILIES)


def test_v2_step_trains_the_branch_only(v2):
    """One ``v2`` step against ``make_optimizer``'s on the JAX gradients
    (a part of the stack, as ``test_torch_train``'s optimizer tests), and
    the port's own step: the base UNet, plain text encoder and VAE bitwise
    unchanged, every branch and task-tower leaf moved."""
    sub = {"unet": {"conv_in": v2["trees"]["unet"]["conv_in"]},
           "text_encoder": {"final_layer_norm":
                            v2["trees"]["text_encoder"]["final_layer_norm"]},
           "brushnet": {k: v2["trees"]["brushnet"][k]
                        for k in ("conv_in_condition", "mid_block")},
           "text_encoder_brushnet": {
               k: v2["trees"]["text_encoder_brushnet"][k]
               for k in ("external_embedding", "final_layer_norm")},
           "vae": {"encoder": {"conv_in": v2["trees"]["vae"]["encoder"]["conv_in"]}}}
    gsub = {f: {k: v2["grads"][f][k] for k in sub[f]} for f in V2_FAMILIES}
    gsub["vae"] = jax.tree.map(np.zeros_like, sub["vae"])
    tx_j = make_optimizer(LR, labels=jax_trainable_mask(sub, "v2"))
    updates, _ = jax.jit(tx_j.update)(gsub, tx_j.init(sub), sub)
    want = optax.apply_updates(sub, updates)
    params = port_params(sub)
    grads = {k: torch.from_numpy(np.array(v, np.float32))
             for k, v in flatten(port_params(gsub)).items()}
    tx = AdamW(LR, labels=trainable_mask(params, "v2"))
    tx.update(grads, tx.init(params), params)
    assert_params_match(params, want, LR)

    params = {f: {k: v.clone() for k, v in sd.items()}
              for f, sd in v2["params"].items()}
    before = {k: v.clone() for k, v in flatten(params).items()}
    labels = trainable_mask(params, "v2")
    tx = AdamW(LR, labels=labels)
    state = init_train_state(params, tx)
    make_train_step(make_v2_loss(v2["cfg"]), tx)(state, v2["batch"],
                                                  v2["draws"])
    for k, v in flatten(params).items():
        assert torch.equal(v, before[k]) != labels[k], k
    assert {k.split("/")[0] for k, t in labels.items() if t} == {
        "brushnet", "text_encoder_brushnet"}
