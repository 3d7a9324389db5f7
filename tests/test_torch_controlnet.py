"""The port's ControlNet models against the JAX package's, in fp32 at the
tiny ppt-v1 + ControlNet config: the branch's 13 residuals (scaled and in
guess mode), the 9-channel UNet with residuals added, the weight import of
one branch and of two, the full-width parameter shapes, and the host-side
canny preprocessor; then the call surface's gating table against the JAX
pipeline's and its argument errors, raised before any device work.

One set of weights (the port's random init, every bias and norm parameter
made random too; the zero convs and the embedding's conv_out are random in
``init_state``) goes to the JAX models through the JAX package's converters
and back to the port through ``params_from_jax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powerpaint_tpu.core.config import (
    ppt_v1_controlnet_config as jax_ppt_v1_controlnet_config,
)
from powerpaint_tpu.io.convert import (
    convert_clip_text,
    convert_controlnet,
    convert_unet,
    convert_vae,
)
from powerpaint_tpu.models.controlnet import ControlNetModel as JaxControlNet
from powerpaint_tpu.models.unet import UNet2DConditionModel as JaxUNet
from powerpaint_tpu.pipelines.controlnet import (
    ControlNetPipeline as JaxPipeline,
)
from powerpaint_tpu.tasks import control as jax_control
from powerpaint_tpu.testing import (
    tiny_v1_controlnet_config as jax_tiny_v1_controlnet_config,
)
from powerpaint_tpu_torch.core.config import ppt_v1_controlnet_config
from powerpaint_tpu_torch.core.validation import InputValidationError
from powerpaint_tpu_torch.io.weights import (
    CN_FAMILIES,
    build_models,
    init_state,
    load_models,
    params_from_jax,
)
from powerpaint_tpu_torch.pipelines.controlnet import ControlNetPipeline
from powerpaint_tpu_torch.tasks import control
from powerpaint_tpu_torch.testing import tiny_v1_controlnet_config
from powerpaint_tpu_torch.text.tokenizer import (
    HashTokenizer,
    TokenizerWrapper,
    add_task_tokens,
)


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
CONVERT = {"unet": convert_unet, "vae": convert_vae,
           "text_encoder": convert_clip_text, "controlnet": convert_controlnet}


def cn_weights(seed: int = 0):
    """Numpy state dicts of every ppt-v1 + ControlNet family with random
    biases and norm affines, and the JAX package's trees of the same
    weights."""
    state = init_state(tiny_v1_controlnet_config(),
                       torch.Generator().manual_seed(seed), device="cpu")
    rng = np.random.RandomState(seed)
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
    sd_np, trees = cn_weights()
    port_state = {f: params_from_jax(t, f) for f, t in trees.items()}
    models = load_models(tiny_v1_controlnet_config(), port_state, device="cpu",
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
            rng.rand(2, 64, 64, 3).astype(np.float32),  # [0, 1], as the pipeline
            np.asarray([981, 501], np.int32))


@pytest.mark.parametrize("guess_mode,scale", [(False, 0.8), (True, 1.0)],
                         ids=["scaled", "guess_mode"])
def test_controlnet_residuals_match_jax(weights, guess_mode, scale):
    _, trees, models = weights
    cfg = jax_tiny_v1_controlnet_config()
    sample, ctx, cond, t = _branch_inputs()
    want = jax.jit(lambda p, *a: JaxControlNet(cfg.controlnet, dtype=F32).apply(
        p, *a, conditioning_scale=scale, guess_mode=guess_mode))(
        {"params": trees["controlnet"]}, sample, t, ctx, cond)
    (branch,) = models["controlnet"]
    down, mid = branch(_t(sample), torch.from_numpy(t), _t(ctx), _t(cond),
                       scale, guess_mode=guess_mode)
    assert len(down) == len(want[0]) == 12
    for got, ref in zip(down + [mid], list(want[0]) + [want[1]]):
        assert float(np.abs(np.asarray(ref)).max()) > 1e-3  # live residuals
        _close(got, ref)


def test_unet_with_residuals_matches_jax(weights):
    _, trees, models = weights
    cfg = jax_tiny_v1_controlnet_config()
    rng = np.random.RandomState(6)
    sample = rng.randn(2, 8, 8, 9).astype(np.float32)
    ctx = rng.randn(2, 77, 32).astype(np.float32)
    t = np.asarray([981, 501], np.int32)
    down = [rng.randn(2, 8 // s, 8 // s, c).astype(np.float32)
            for c, s in zip(cfg.unet.controlnet_residual_channels(),
                            cfg.unet.down_tap_strides())]
    mid = rng.randn(2, 1, 1, cfg.unet.block_out_channels[-1]).astype(np.float32)
    want = jax.jit(JaxUNet(cfg.unet, dtype=F32).apply)(
        {"params": trees["unet"]}, sample, t, ctx,
        down_block_additional_residuals=tuple(down),
        mid_block_additional_residual=mid)
    got = models["unet"](_t(sample), torch.from_numpy(t), _t(ctx),
                         down_block_additional_residuals=[_t(d) for d in down],
                         mid_block_additional_residual=_t(mid))
    _close(got, want)
    plain = models["unet"](_t(sample), torch.from_numpy(t), _t(ctx))
    assert float((plain - got).abs().max()) > 0.1  # the residuals are used
    with pytest.raises(ValueError, match="12 skip connections"):
        models["unet"](_t(sample), torch.from_numpy(t), _t(ctx),
                       down_block_additional_residuals=[_t(d) for d in down[1:]])


@pytest.mark.parametrize("branches", [1, 2])
def test_controlnet_round_trip_through_the_jax_converter(weights, branches):
    sd_np, trees, _ = weights
    sds = [sd_np["controlnet"]]
    if branches == 2:
        sds.append(cn_weights(seed=1)[0]["controlnet"])
    tree = trees["controlnet"] if branches == 1 else tuple(
        convert_controlnet(sd) for sd in sds)
    back = params_from_jax(tree, "controlnet")
    back = [back] if branches == 1 else back
    assert len(back) == branches
    for got, want in zip(back, sds):
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    state = {f: sd_np[f] for f in CN_FAMILIES[:-1]}
    state["controlnet"] = back if branches == 2 else back[0]
    models = load_models(tiny_v1_controlnet_config(), state, device="cpu",
                         dtype=torch.float32)
    assert len(models["controlnet"]) == branches
    for model, want in zip(models["controlnet"], sds):
        np.testing.assert_array_equal(
            model.controlnet_cond_embedding.blocks[5].weight.numpy(),
            want["controlnet_cond_embedding.blocks.5.weight"])


def _flax_shapes(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_flax_shapes(v, prefix + (k,)) if isinstance(v, dict)
                   else {prefix + (k,): tuple(v.shape)})
    return out


def test_full_width_controlnet_has_the_jax_models_shapes():
    """The SD1.5 branch of ``ppt_v1_controlnet_config()``: its conv_in sees
    the 4 latent channels though its base config is the 9-channel UNet."""
    model = build_models(ppt_v1_controlnet_config())["controlnet"]
    assert tuple(model.conv_in.weight.shape) == (320, 4, 3, 3)
    cfg = jax_ppt_v1_controlnet_config()
    want = jax.eval_shape(
        JaxControlNet(cfg.controlnet, dtype=F32).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 77, 768)), jnp.zeros((1, 64, 64, 3)))["params"]
    # the port's names and shapes (no memory: zero-stride views), mapped as
    # the JAX converter maps them
    got_tree = {k: np.lib.stride_tricks.as_strided(
        np.zeros(1, np.float32), tuple(v.shape), (0,) * v.dim())
        for k, v in model.state_dict().items()}
    got = _flax_shapes(convert_controlnet(got_tree))
    assert got == _flax_shapes(want)


def test_canny_matches_jax():
    rng = np.random.RandomState(3)
    image = np.zeros((96, 80, 3), np.uint8)
    image[20:70, 15:60] = 200
    image[40:50, 30:75] = (30, 220, 90)
    image = np.clip(image.astype(int) + rng.randint(0, 40, image.shape),
                    0, 255).astype(np.uint8)
    got = control.get_control_image("canny", image)
    want = jax_control.get_control_image("canny", image)
    assert got.shape == (96, 80, 3) and got.dtype == np.uint8
    assert got.any()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(control.canny(image, 50, 100),
                                  jax_control.canny(image, 50, 100))


@pytest.mark.parametrize("kind", ["depth", "hed", "pose"])
def test_annotators_name_their_roadmap_item(kind):
    """Unregistered (their weights are not bundled), an annotator's control
    type raises and names the function that registers it."""
    register = {"depth": "register_dpt_depth", "hed": "register_hed",
                "pose": "register_openpose"}[kind]
    control._REGISTRY.pop(kind, None)
    with pytest.raises(NotImplementedError, match=register):
        control.get_control_image(kind, np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(NotImplementedError, match="unknown control type"):
        control.get_control_image("sketch", np.zeros((8, 8, 3), np.uint8))


# ---------------------------------------------------------------------------
# the call surface: gating table and argument errors
# ---------------------------------------------------------------------------


class Captured(Exception):
    pass


@pytest.fixture(scope="module")
def two_branch_pipes(weights):
    """A two-branch ControlNet pipeline on each side whose generate only
    records its arguments: nothing here reaches a model."""
    sd_np, trees, _ = weights
    tok = TokenizerWrapper(HashTokenizer(994))
    add_task_tokens(tok)
    params = dict(trees, controlnet=(trees["controlnet"], trees["controlnet"]))
    jax_pipe = JaxPipeline(jax_tiny_v1_controlnet_config(), params, tok,
                           dtype=F32)
    state = dict(sd_np, controlnet=[sd_np["controlnet"]] * 2)
    port = ControlNetPipeline(tiny_v1_controlnet_config(), state, tok,
                              dtype=torch.float32, device="cpu")
    seen = {}

    def jax_generate(*args):
        seen["jax"] = args
        raise Captured

    def port_generate(*args, **kw):
        seen["port"] = (args, kw)
        raise Captured

    jax_pipe._generate_cn = jax_generate
    port._generate = port_generate
    return jax_pipe, port, seen


def _call_inputs(hw=64):
    rng = np.random.RandomState(2)
    image = (rng.rand(hw, hw, 3) * 255).astype(np.uint8)
    mask = np.zeros((hw, hw), np.float32)
    mask[10:40, 20:50] = 1.0
    edges = (rng.rand(hw, hw, 3) > 0.8).astype(np.uint8) * 255
    return image, mask, edges


@pytest.mark.parametrize("kw", [
    dict(num_inference_steps=10),
    dict(num_inference_steps=10, strength=0.6,
         controlnet_conditioning_scale=[0.5, 1.5],
         control_guidance_start=[0.0, 0.2], control_guidance_end=[0.5, 1.0]),
    dict(num_inference_steps=7, controlnet_conditioning_scale=0.8,
         control_guidance_end=0.6, guess_mode=True)],
    ids=["plain", "strength+per-branch", "guess_mode"])
def test_gating_table_and_inputs_match_jax(two_branch_pipes, kw):
    jax_pipe, port, seen = two_branch_pipes
    image, mask, edges = _call_inputs()
    args = dict(prompt="a red bench", seed=4, **kw)
    with pytest.raises(Captured):
        jax_pipe(image, mask, control_image=[edges, 255 - edges], **args)
    with pytest.raises(Captured):
        port(image, mask, [edges, 255 - edges], **args)
    j = seen["jax"]
    (ids, fit, img, msk, guide, *_), pk = seen["port"]
    np.testing.assert_array_equal(pk["scales"], np.asarray(j[8]))
    np.testing.assert_array_equal(pk["control_u8"].numpy(), np.asarray(j[6]))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j[1])[None])
    np.testing.assert_array_equal(img.numpy(), np.asarray(j[4]))
    np.testing.assert_array_equal(msk.numpy(), np.asarray(j[5]))
    assert pk["strength_steps"] == j[14]
    assert pk["guess_mode"] == j[18] == kw.get("guess_mode", False)


@pytest.mark.parametrize("control,kw,match", [
    ("one", {}, "1 control images for 2"),
    ("two", dict(controlnet_conditioning_scale=[1.0, 1.0, 1.0]), "length-2 list"),
    ("two", dict(control_guidance_end=[1.0]), "length-2 list"),
    ("two", dict(control_guidance_start=0.6, control_guidance_end=0.5),
     "control_guidance_start"),
    ("small", {}, "must match image"),
    ("two", dict(scheduler="karras"), "unknown scheduler"),
    ("two", dict(task="paint"), "unknown task"),
    ("three requests", dict(prompt=["a", "b"]), "3 control entries for 2"),
], ids=["images", "scales", "window-length", "window", "size", "scheduler",
        "task", "batch"])
def test_bad_arguments_raise_before_device_work(two_branch_pipes, control, kw,
                                                match):
    _, port, seen = two_branch_pipes
    image, mask, edges = _call_inputs()
    seen.pop("port", None)
    control_image = {"one": [edges], "two": [edges, edges],
                     "small": [edges[:32], edges],
                     "three requests": [[edges, edges]] * 3}[control]
    with pytest.raises(InputValidationError, match=match):
        port(image, mask, control_image, num_inference_steps=4, **kw)
    assert "port" not in seen
