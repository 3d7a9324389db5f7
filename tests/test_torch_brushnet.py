"""The port's ppt-v2 models against the JAX package's, in fp32 at the tiny
v2 config: the BrushNet branch (all 28 taps, with and without guess mode),
the base UNet with the taps injected, and the weight import of the v2
families.

One set of weights (the port's random init, every bias and norm parameter
made random too; the zero convs are random in ``init_state``) goes to the
JAX models through the JAX package's converters and back to the port
through ``params_from_jax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powerpaint_tpu.io.convert import (
    convert_brushnet,
    convert_clip_text,
    convert_unet,
    convert_vae,
)
from powerpaint_tpu.models.brushnet import BrushNetModel as JaxBrushNet
from powerpaint_tpu.models.clip_text import CLIPTextModel as JaxCLIP
from powerpaint_tpu.models.unet import UNet2DConditionModel as JaxUNet
from powerpaint_tpu.testing import tiny_v2_config as jax_tiny_v2_config
from powerpaint_tpu_torch.io.weights import (
    V2_FAMILIES,
    build_models,
    init_state,
    load_models,
    params_from_jax,
)
from powerpaint_tpu_torch.testing import tiny_v2_config


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are tiny, and the suite's parallel
    workers would otherwise oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F32 = jnp.float32
ATOL, RTOL = 2e-4, 1e-4
CONVERT = {"unet": convert_unet, "vae": convert_vae, "brushnet": convert_brushnet,
           "text_encoder": convert_clip_text,
           "text_encoder_brushnet": convert_clip_text}


def v2_weights():
    """Numpy state dicts of every v2 family with random biases and norm
    affines, and the JAX package's trees of the same weights."""
    state = init_state(tiny_v2_config(), torch.Generator().manual_seed(0),
                       device="cpu")
    rng = np.random.RandomState(0)
    sd_np = {}
    for family, sd in state.items():
        sd_np[family] = {k: v.numpy() for k, v in sd.items()}
        for k, v in sd_np[family].items():
            if v.ndim == 1:
                sd_np[family][k] = (v + 0.1 * rng.randn(*v.shape)).astype(np.float32)
    trees = {f: CONVERT[f](sd) for f, sd in sd_np.items()}
    return sd_np, trees


@pytest.fixture(scope="module")
def weights():
    sd_np, trees = v2_weights()
    port_state = {f: params_from_jax(t, f) for f, t in trees.items()}
    models = load_models(tiny_v2_config(), port_state, device="cpu",
                         dtype=torch.float32)
    return sd_np, trees, models


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def _branch_inputs():
    rng = np.random.RandomState(5)
    return (rng.randn(2, 8, 8, 4).astype(np.float32),
            rng.randn(2, 77, 32).astype(np.float32),
            rng.randn(2, 8, 8, 5).astype(np.float32),
            np.asarray([981, 501], np.int32))


@pytest.mark.parametrize("guess_mode,scale", [(False, 0.8), (True, 1.0)],
                         ids=["scaled", "guess_mode"])
def test_brushnet_taps_match_jax(weights, guess_mode, scale):
    _, trees, models = weights
    cfg = jax_tiny_v2_config()
    sample, ctx, cond, t = _branch_inputs()
    want = jax.jit(lambda p, *a: JaxBrushNet(cfg.brushnet, dtype=F32).apply(
        p, *a, conditioning_scale=scale, guess_mode=guess_mode))(
        {"params": trees["brushnet"]}, sample, t, ctx, cond)
    down, mid, up = models["brushnet"](_t(sample), torch.from_numpy(t),
                                       _t(ctx), _t(cond), scale,
                                       guess_mode=guess_mode)
    assert (len(down), len(up)) == (12, 15)
    for got, ref in zip(down + [mid] + up, list(want[0]) + [want[1]] + list(want[2])):
        assert float(np.abs(np.asarray(ref)).max()) > 1e-3  # live taps
        _close(got, ref)


def test_unet_with_injected_taps_matches_jax(weights):
    _, trees, models = weights
    cfg = jax_tiny_v2_config()
    rng = np.random.RandomState(6)
    sample = rng.randn(2, 8, 8, 4).astype(np.float32)
    ctx = rng.randn(2, 77, 32).astype(np.float32)
    t = np.asarray([981, 501], np.int32)
    down = [rng.randn(2, 8 // s, 8 // s, c).astype(np.float32)
            for c, s in zip(cfg.unet.down_tap_channels(),
                            cfg.unet.down_tap_strides())]
    mid = rng.randn(2, 1, 1, cfg.unet.mid_tap_channels()).astype(np.float32)
    up = [rng.randn(2, 8 // s, 8 // s, c).astype(np.float32)
          for c, s in zip(cfg.unet.up_tap_channels(), cfg.unet.up_tap_strides())]
    want = jax.jit(JaxUNet(cfg.unet, dtype=F32).apply)(
        {"params": trees["unet"]}, sample, t, ctx,
        down_block_add_samples=tuple(down), mid_block_add_sample=mid,
        up_block_add_samples=tuple(up))
    got = models["unet"](_t(sample), torch.from_numpy(t), _t(ctx),
                         down_block_add_samples=[_t(d) for d in down],
                         mid_block_add_sample=_t(mid),
                         up_block_add_samples=[_t(u) for u in up])
    _close(got, want)
    plain = models["unet"](_t(sample), torch.from_numpy(t), _t(ctx))
    assert float((plain - got).abs().max()) > 0.1  # the taps are used


@pytest.mark.parametrize("family", V2_FAMILIES)
def test_v2_round_trip_through_the_jax_converter(weights, family):
    sd_np, trees, _ = weights
    back = params_from_jax(trees[family], family)
    assert sorted(back) == sorted(sd_np[family])
    for k, v in sd_np[family].items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.mark.parametrize("family", ["brushnet", "text_encoder",
                                    "text_encoder_brushnet"])
def test_converted_v2_trees_have_the_jax_models_shapes(weights, family):
    _, trees, _ = weights
    cfg = jax_tiny_v2_config()
    key = jax.random.PRNGKey(0)
    if family == "brushnet":
        shapes = jax.eval_shape(
            JaxBrushNet(cfg.brushnet, dtype=F32).init, key,
            jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
            jnp.zeros((1, 77, 32)), jnp.zeros((1, 8, 8, 5)))
    else:
        text = cfg.text_encoder
        if family == "text_encoder":
            text = text.replace(num_external_tokens=0)
        shapes = jax.eval_shape(JaxCLIP(text, dtype=F32).init, key,
                                jnp.zeros((1, 77), jnp.int32))

    def flat(tree, prefix=()):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, prefix + (k,)) if isinstance(v, dict)
                       else {prefix + (k,): tuple(v.shape)})
        return out

    assert flat(trees[family]) == flat(shapes["params"])


def test_v2_families_and_the_two_text_towers():
    models = build_models(tiny_v2_config())
    assert tuple(models) == V2_FAMILIES
    task = models["text_encoder_brushnet"].text_model.embeddings.token_embedding
    plain = models["text_encoder"].text_model.embeddings.token_embedding
    assert sum(p.shape[0] for p in task.trainable_embeddings.values()) == 30
    assert isinstance(plain, torch.nn.Embedding)
    assert len(models["brushnet"].brushnet_down_blocks) == 12
    assert len(models["brushnet"].brushnet_up_blocks) == 15
