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
        # controlnet and t2i_adapter are families now
        params_from_jax({}, "ema_unet")


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


def test_lcm_time_cond_proj_carries_both_ways_and_matches_jax():
    """``time_embedding.cond_proj.weight`` (a bias-free linear) goes from a
    diffusers state dict into the port's UNet and, through the JAX
    package's converter and ``params_from_jax``, back unchanged; the UNet
    forward with the guidance embedding as ``timestep_cond`` equals the JAX
    one at the tiny config."""
    from powerpaint_tpu.models.layers import (
        guidance_scale_embedding as jax_guidance_embedding,
    )
    from powerpaint_tpu_torch.models.layers import guidance_scale_embedding
    from powerpaint_tpu_torch.models.unet import UNet2DConditionModel

    cfg = tiny_v1_config()
    cfg = cfg.replace(unet=cfg.unet.replace(time_cond_proj_dim=8))
    sd = {k: v.numpy() for k, v in init_state(
        cfg, torch.Generator().manual_seed(3), device="cpu")["unet"].items()}
    assert sd["time_embedding.cond_proj.weight"].shape == (32, 8)
    assert "time_embedding.cond_proj.bias" not in sd
    tree = convert_unet(sd)
    assert tree["time_embedding"]["cond_proj"]["kernel"].shape == (8, 32)
    back = params_from_jax(tree, "unet")
    assert back.keys() == sd.keys()
    np.testing.assert_array_equal(back["time_embedding.cond_proj.weight"],
                                  sd["time_embedding.cond_proj.weight"])
    unet = UNet2DConditionModel(cfg.unet).eval()
    unet.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                         strict=True)

    w = np.asarray([4.0, 6.5], np.float32)
    emb = guidance_scale_embedding(torch.from_numpy(w), 8)
    np.testing.assert_allclose(emb.numpy(), np.asarray(
        jax_guidance_embedding(jnp.asarray(w), 8)), atol=2e-5, rtol=2e-4)
    jax_cfg = jax_tiny_v1_config()
    jax_cfg = jax_cfg.replace(unet=jax_cfg.unet.replace(time_cond_proj_dim=8))
    rng = np.random.RandomState(3)
    sample = rng.randn(2, 8, 8, 9).astype(np.float32)
    ctx = rng.randn(2, 77, 32).astype(np.float32)
    t = np.asarray([981, 501], np.int32)
    want = jax.jit(JaxUNet(jax_cfg.unet, dtype=jnp.float32).apply)(
        {"params": tree}, sample, t, ctx, timestep_cond=jnp.asarray(emb.numpy()))
    with torch.no_grad():
        got = unet(torch.from_numpy(sample), torch.from_numpy(t),
                   torch.from_numpy(ctx), timestep_cond=emb)
        plain = unet(torch.from_numpy(sample), torch.from_numpy(t),
                     torch.from_numpy(ctx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=1e-4)
    assert not torch.allclose(plain, got, atol=1e-3)
