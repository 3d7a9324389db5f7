"""The port's weight import (``powerpaint_tpu_torch.io.weights``).

``params_from_jax`` inverts the JAX package's checkpoint converter: a port
state dict (diffusers / transformers names) taken through
``powerpaint_tpu.io.convert`` and back must come out unchanged, and the
converted tree must have exactly the shapes the JAX models declare.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powerpaint_tpu.io.convert import convert_clip_text, convert_unet, convert_vae
from powerpaint_tpu.models.clip_text import CLIPTextModel as JaxCLIP
from powerpaint_tpu.models.unet import UNet2DConditionModel as JaxUNet
from powerpaint_tpu.models.vae import AutoencoderKL as JaxVAE
from powerpaint_tpu.testing import tiny_v1_config as jax_tiny_v1_config
from powerpaint_tpu_torch.io.weights import (
    FAMILIES,
    build_models,
    init_state,
    load_models,
    params_from_jax,
)
from powerpaint_tpu_torch.testing import tiny_v1_config


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are tiny, and the suite's parallel
    workers would otherwise oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CONVERT = {"unet": convert_unet, "vae": convert_vae,
           "text_encoder": convert_clip_text}


@pytest.fixture(scope="module")
def state_np():
    state = init_state(tiny_v1_config(), torch.Generator().manual_seed(0),
                       device="cpu")
    return {f: {k: v.numpy() for k, v in sd.items()} for f, sd in state.items()}


def _flat_shapes(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_shapes(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = tuple(v.shape)
    return out


@pytest.mark.parametrize("family", FAMILIES)
def test_round_trip_through_the_jax_converter(state_np, family):
    sd = state_np[family]
    back = params_from_jax(CONVERT[family](sd), family)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.mark.parametrize("family", FAMILIES)
def test_converted_tree_has_the_jax_models_shapes(state_np, family):
    cfg = jax_tiny_v1_config()
    key = jax.random.PRNGKey(0)
    if family == "unet":
        shapes = jax.eval_shape(
            JaxUNet(cfg.unet, dtype=jnp.float32).init, key,
            jnp.zeros((1, 8, 8, 9)), jnp.zeros((1,), jnp.int32),
            jnp.zeros((1, 77, cfg.unet.cross_attention_dim)))
    elif family == "vae":
        shapes = jax.eval_shape(
            JaxVAE(cfg.vae, dtype=jnp.float32).init, key,
            jnp.zeros((1, 64, 64, 3)), key)
    else:
        shapes = jax.eval_shape(
            JaxCLIP(cfg.text_encoder, dtype=jnp.float32).init, key,
            jnp.zeros((1, 77), jnp.int32))
    want = _flat_shapes(shapes["params"])
    got = _flat_shapes(CONVERT[family](state_np[family]))
    assert got == want


def test_params_from_jax_rejects_unknown_family():
    with pytest.raises(ValueError):
        params_from_jax({}, "t2i_adapter")  # controlnet is a family now


def test_init_state_matches_the_modules(state_np):
    models = build_models(tiny_v1_config())
    for family in FAMILIES:
        want = {k: tuple(v.shape) for k, v in models[family].state_dict().items()}
        got = {k: tuple(v.shape) for k, v in state_np[family].items()}
        assert got == want, family


def test_load_models_keeps_norms_fp32_and_casts_compute(state_np):
    models = load_models(tiny_v1_config(), state_np, device="cpu",
                         dtype=torch.bfloat16)
    unet = models["unet"]
    assert unet.conv_in.weight.dtype == torch.bfloat16
    assert unet.down_blocks[0].resnets[0].norm1.weight.dtype == torch.float32
    assert unet.time_embedding.linear_1.weight.dtype == torch.bfloat16
    emb = models["text_encoder"].text_model.embeddings.token_embedding
    assert emb.wrapped.weight.dtype == torch.float32
    with pytest.raises(RuntimeError):
        load_models(tiny_v1_config(),
                    {**state_np, "vae": {k: v for k, v in state_np["vae"].items()
                                         if "quant_conv" not in k}},
                    device="cpu", dtype=torch.float32)
