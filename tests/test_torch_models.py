"""The port's models against the JAX package's, in fp32 at the tiny config.

One set of weights (the port's random init with every bias and norm
parameter made random too) goes to the JAX models through the JAX
package's converter and back to the port through ``params_from_jax``; the
same numpy inputs go through both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powerpaint_tpu.io.convert import convert_clip_text, convert_unet, convert_vae
from powerpaint_tpu.models.clip_text import CLIPTextModel as JaxCLIP
from powerpaint_tpu.models.resnet import ResnetBlock2D as JaxResnet
from powerpaint_tpu.models.transformer import Transformer2DModel as JaxTransformer
from powerpaint_tpu.models.unet import UNet2DConditionModel as JaxUNet
from powerpaint_tpu.models.vae import AutoencoderKL as JaxVAE
from powerpaint_tpu.testing import tiny_v1_config as jax_tiny_v1_config
from powerpaint_tpu_torch.io.weights import init_state, load_models, params_from_jax
from powerpaint_tpu_torch.testing import tiny_v1_config
from powerpaint_tpu_torch.text.prompts import add_task
from powerpaint_tpu_torch.text.tokenizer import (
    HashTokenizer,
    TokenizerWrapper,
    add_task_tokens,
)

F32 = jnp.float32
ATOL, RTOL = 2e-4, 1e-4


@pytest.fixture(scope="module")
def weights():
    state = init_state(tiny_v1_config(), torch.Generator().manual_seed(0),
                       device="cpu")
    rng = np.random.RandomState(0)
    trees = {}
    for family, sd in state.items():
        sd = {k: v.numpy() for k, v in sd.items()}
        for k, v in sd.items():  # random biases and norm affines too
            if v.ndim == 1:
                sd[k] = (v + 0.1 * rng.randn(*v.shape)).astype(np.float32)
        trees[family] = {"unet": convert_unet, "vae": convert_vae,
                         "text_encoder": convert_clip_text}[family](sd)
    port_state = {f: params_from_jax(t, f) for f, t in trees.items()}
    models = load_models(tiny_v1_config(), port_state, device="cpu",
                         dtype=torch.float32)
    return trees, models


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def test_resnet_block(weights):
    trees, models = weights
    rng = np.random.RandomState(1)
    x = rng.randn(2, 8, 8, 32).astype(np.float32)
    temb = rng.randn(2, 128).astype(np.float32)
    want = JaxResnet(64, 1e-5, 32, dtype=F32).apply(
        {"params": trees["unet"]["down_blocks_1"]["resnets_0"]},
        jnp.asarray(x), jnp.asarray(temb))
    got = models["unet"].down_blocks[1].resnets[0](_t(x), _t(temb))
    _close(got, want)


def test_transformer(weights):
    trees, models = weights
    rng = np.random.RandomState(2)
    x = rng.randn(2, 8, 8, 64).astype(np.float32)
    ctx = rng.randn(2, 77, 32).astype(np.float32)
    want = JaxTransformer(2, 32, dtype=F32).apply(
        {"params": trees["unet"]["down_blocks_1"]["attentions_0"]},
        jnp.asarray(x), jnp.asarray(ctx))
    got = models["unet"].down_blocks[1].attentions[0](_t(x), _t(ctx))
    _close(got, want)


def test_unet_forward(weights):
    trees, models = weights
    cfg = jax_tiny_v1_config()
    rng = np.random.RandomState(3)
    sample = rng.randn(2, 8, 8, 9).astype(np.float32)
    ctx = rng.randn(2, 77, 32).astype(np.float32)
    t = np.asarray([981, 501], np.int32)
    want = jax.jit(JaxUNet(cfg.unet, dtype=F32).apply)(
        {"params": trees["unet"]}, sample, t, ctx)
    got = models["unet"](_t(sample), torch.from_numpy(t), _t(ctx))
    _close(got, want)


@pytest.mark.parametrize("clip_skip", [0, 1])
def test_clip_forward_with_task_rows(weights, clip_skip):
    trees, models = weights
    cfg = jax_tiny_v1_config()
    tok = TokenizerWrapper(HashTokenizer(994))
    add_task_tokens(tok)
    p = add_task("a cat on a sofa", "", "shape-guided")
    ids = tok([p.promptA, p.promptB, p.negative_promptA, p.negative_promptB])
    assert ids.max() >= 994  # the task-token rows are looked up
    want = jax.jit(JaxCLIP(cfg.text_encoder, dtype=F32).apply,
                   static_argnames="clip_skip")(
        {"params": trees["text_encoder"]}, ids, clip_skip=clip_skip)
    got = models["text_encoder"](torch.from_numpy(ids).long(),
                                 clip_skip=clip_skip)
    _close(got, want)


def test_vae_encode_moments_and_decode(weights):
    trees, models = weights
    cfg = jax_tiny_v1_config()
    vae = JaxVAE(cfg.vae, dtype=F32)
    rng = np.random.RandomState(4)
    x = (rng.rand(1, 64, 64, 3) * 2 - 1).astype(np.float32)
    z = rng.randn(1, 8, 8, 4).astype(np.float32)
    mean, logvar = jax.jit(lambda p, x: vae.apply(p, x, method="encode"))(
        {"params": trees["vae"]}, x)
    dec = jax.jit(lambda p, z: vae.apply(p, z, method="decode"))(
        {"params": trees["vae"]}, z)
    got_mean, got_logvar = models["vae"].encode(_t(x))
    _close(got_mean, mean)
    _close(got_logvar, logvar)
    _close(models["vae"].decode(_t(z)), dec)
