"""The call surface the port's three pipelines share with the reference's
diffusers pipelines, against the JAX package's: ``prompt_embeds`` /
``negative_prompt_embeds``, ``callback`` / ``callback_steps``, ``height`` /
``width``, and ppt-v2's ``timesteps=`` and IP-Adapter arguments.

The host pieces (``norm_embeds``, the ``height`` / ``width`` resize, the
custom-timestep checks and every UniPC coefficient table on a custom grid,
the ControlNet control-image resize) are compared exactly with the JAX
package's on the same inputs. One JAX pipeline call holds all of them
together: a tiny ppt-v2 call at a non-square size on a 6-step custom grid
with given embeddings, a callback and an IP-Adapter's image embedding
(``ip_adapter_image_embeds``, ``ip_adapter_scale``; the adapter a
synthetic ``ip-adapter_sd15`` checkpoint through each package's
converter), fed the same weights (``params_from_jax`` of the JAX trees),
the same injected latents and the same VAE sample noise; the fp32 images
must agree within 1e-3 (and so within 1 uint8 level) and the latents the
callback sees within 1e-4 of their largest magnitude at every step it
sees. The rest
are the port's own checks: given embeddings equal to the pipeline's own
pair give its image bitwise without running the text encoder (the task
tower on ppt-v2), a callback sees copies, ``callback_steps=0`` is clamped,
and ``timesteps=`` with another sampler is refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powerpaint_tpu.core import validation as jax_validation
from powerpaint_tpu.io import convert as jax_convert
from powerpaint_tpu.pipelines import common as jax_common
from powerpaint_tpu.pipelines.brushnet import BrushNetPipeline as JaxPipeline
from powerpaint_tpu.pipelines.inpaint import InpaintPipeline as JaxInpaint
from powerpaint_tpu.schedulers import common as jax_sched
from powerpaint_tpu.schedulers import unipc as jax_unipc
from powerpaint_tpu.tasks.preprocess import resize_to as jax_resize_to
from powerpaint_tpu.testing import tiny_v2_config as jax_tiny_v2_config
from powerpaint_tpu_torch.core.config import SchedulerConfig
from powerpaint_tpu_torch.core.validation import InputValidationError
from powerpaint_tpu_torch.io.weights import init_state, params_from_jax
from powerpaint_tpu_torch.pipelines import brushnet as port_brushnet
from powerpaint_tpu_torch.pipelines import common
from powerpaint_tpu_torch.pipelines.brushnet import BrushNetPipeline
from powerpaint_tpu_torch.pipelines.controlnet import ControlNetPipeline
from powerpaint_tpu_torch.pipelines.inpaint import InpaintPipeline
from powerpaint_tpu_torch.schedulers import common as port_sched
from powerpaint_tpu_torch.schedulers import unipc as port_unipc
from powerpaint_tpu_torch.testing import (
    tiny_v1_config,
    tiny_v1_controlnet_config,
    tiny_v2_config,
)
from powerpaint_tpu_torch.text.tokenizer import (
    HashTokenizer,
    TokenizerWrapper,
    add_task_tokens,
)
from test_torch_brushnet import v2_weights
from test_torch_ip_adapter import DIM, ip_checkpoint


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are tiny, and the suite's parallel
    workers would otherwise oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _outcome(fn):
    """The value, or the exception's type name and message."""
    try:
        return fn()
    except ValueError as e:
        return type(e).__name__, str(e)


def _image_mask(h=64, w=64, seed=0):
    rng = np.random.RandomState(seed)
    image = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    mask = np.zeros((h, w), np.float32)
    mask[h // 5:3 * h // 4, w // 6:2 * w // 3] = 1.0
    return image, mask


# ---------------------------------------------------------------------------
# host pieces, exactly as the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [None, (77, 32), (1, 77, 32), (2, 77, 32)],
                         ids=str)
def test_norm_embeds_matches_jax(shape):
    e = None if shape is None else np.random.RandomState(0).randn(*shape)
    got, want = common.norm_embeds(e), jax_common.norm_embeds(e)
    if shape is None:
        assert got is None and want is None
        return
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw,multi", [((48, 64), False), ((128, 64), False),
                                      ((40, 56), True), ((None, 64), False),
                                      ((48, None), True), ((44, 64), False)],
                         ids=str)
def test_apply_target_hw_matches_jax(hw, multi):
    """The resize of image and mask, the batched form's stacked pairs, and
    the errors: height without width, a size off the latent grid."""
    image, mask = _image_mask(70, 90)
    args = ((image, image[::-1].copy()), (mask, mask[:, ::-1].copy())) \
        if multi else (image, mask)
    got = _outcome(lambda: common.apply_target_hw(*args, *hw, multi))
    want = _outcome(lambda: JaxInpaint._apply_target_hw(*args, *hw, multi))
    if isinstance(want[0], str):
        assert got == want
        return
    for a, b in zip(got, want):
        for x, y in (zip(a, b) if multi else [(a, b)]):
            np.testing.assert_array_equal(x, y)


TIMESTEP_LISTS = [[999, 900, 700, 500, 300, 100], [950, 10], [500],
                  [999, 999, 500], [100, 500], [1000, 10], [999, -1], [],
                  [[999, 500]]]


@pytest.mark.parametrize("custom", TIMESTEP_LISTS, ids=str)
def test_custom_timesteps_match_jax(custom):
    cfg = SchedulerConfig()
    got = _outcome(lambda: port_sched.custom_timesteps_array(cfg, custom))
    want = _outcome(lambda: jax_sched.custom_timesteps_array(cfg, custom))
    if isinstance(want, tuple):
        assert got == want
        return
    np.testing.assert_array_equal(got, want)
    for keep in (None, 1, len(custom), 4):
        np.testing.assert_array_equal(
            port_sched.kept_timesteps(cfg, 7, keep, custom=custom),
            jax_sched.kept_timesteps(cfg, 7, keep, custom=custom))


@pytest.mark.parametrize("custom", [
    [999, 950, 900, 850, 800, 700, 600, 500, 400, 300, 250, 200, 150, 100, 75,
     50, 25, 10],
    [999, 900, 700, 500, 300, 100], [961, 3], [500]], ids=len)
@pytest.mark.parametrize("solver_type", ["bh1", "bh2"])
def test_unipc_custom_tables_match_jax(custom, solver_type):
    """Every coefficient table and the timesteps of UniPC on a custom grid,
    bitwise the JAX package's (both float64 on the host, then fp32)."""
    cfg = SchedulerConfig(solver_type=solver_type)
    got = port_unipc.make_unipc_schedule(cfg, len(custom),
                                         custom_timesteps=custom)
    want = jax_unipc.make_unipc_schedule(cfg, len(custom),
                                         custom_timesteps=custom)
    for name in ("pA", "pB", "pC", "cA", "cB", "cC", "cD"):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(want.coeffs, name)))
    np.testing.assert_array_equal(got.use_corrector,
                                  np.asarray(want.coeffs.use_corrector))
    np.testing.assert_array_equal(got.timesteps, np.asarray(want.timesteps))
    np.testing.assert_array_equal(got.base.prev_timesteps,
                                  np.asarray(want.base.prev_timesteps))
    assert got.num_steps == want.num_steps == len(custom)


@pytest.fixture(scope="module")
def tok():
    t = TokenizerWrapper(HashTokenizer(994))
    add_task_tokens(t)
    return t


@pytest.fixture(scope="module")
def port_pipes(tok):
    """The three tiny pipelines of the port, random weights, on the CPU."""
    out = {}
    for name, cls, cfg in (("v1", InpaintPipeline, tiny_v1_config()),
                           ("v2", BrushNetPipeline, tiny_v2_config()),
                           ("cn", ControlNetPipeline, tiny_v1_controlnet_config())):
        state = init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
        out[name] = cls(cfg, state, tok, dtype=torch.float32, device="cpu")
    return out


@pytest.mark.parametrize("branches", [1, 2])
def test_controlnet_resizes_its_control_images(port_pipes, monkeypatch, branches):
    """``height`` / ``width`` resize each control image as the JAX pipeline
    does (``resize_to``, LANCZOS), one per branch; the image and mask as
    ``_apply_target_hw``."""
    pipe = port_pipes["cn"]
    if branches == 2:
        pipe = ControlNetPipeline.from_pipeline(
            pipe, [pipe.controlnet[0], pipe.controlnet[0]])
    seen = {}
    monkeypatch.setattr(pipe, "_run", lambda req, *a, **kw: seen.update(
        req=req, **kw))
    image, mask = _image_mask(72, 56)
    controls = [_image_mask(72, 56, seed=s)[0] for s in range(branches)]
    pipe(image, mask, controls if branches == 2 else controls[0], prompt="x",
         num_inference_steps=2, height=64, width=128)
    want_img, want_mask = JaxInpaint._apply_target_hw(image, mask, 64, 128, False)
    np.testing.assert_array_equal(seen["req"].images[0], want_img)
    np.testing.assert_array_equal(
        seen["req"].masks[0, ..., 0],
        (want_mask >= 0.5).astype(np.uint8) * 255)
    got = seen["control_u8"].numpy()
    assert got.shape == (branches, 1, 64, 128, 3)
    for n, c in enumerate(controls):
        np.testing.assert_array_equal(got[n, 0], jax_resize_to(c, None, 64, 128)[0])


# ---------------------------------------------------------------------------
# the one JAX pipeline call: all four arguments together
# ---------------------------------------------------------------------------

H, W, SEED = 128, 64, 7
GRID = [981, 800, 601, 400, 222, 40]


def test_v2_call_surface_matches_jax(tok, monkeypatch):
    """A tiny ppt-v2 call with ``timesteps=`` (6 entries), ``height`` /
    ``width`` (a 64x64 input to 128x64), ``prompt_embeds`` and
    ``negative_prompt_embeds``, ``callback`` with ``callback_steps=2``, and
    an IP-Adapter's ``ip_adapter_image_embeds`` at ``ip_adapter_scale``
    0.8, through each package's public ``__call__``."""
    sd_np, trees = v2_weights()
    jcfg, cfg = jax_tiny_v2_config(), tiny_v2_config()
    jcfg = jcfg.replace(unet=jcfg.unet.replace(ip_adapter_dim=DIM))
    cfg = cfg.replace(unet=cfg.unet.replace(ip_adapter_dim=DIM))
    trees = dict(trees, unet=jax_convert.merge_ip_adapter(
        trees["unet"], jax_convert.convert_ip_adapter(
            ip_checkpoint(cfg.unet, 1), jcfg.unet)))
    state = {f: params_from_jax(t, f) for f, t in trees.items()}
    jax_pipe = JaxPipeline(jcfg, trees, tok, dtype=jnp.float32)
    port = BrushNetPipeline(cfg, state, tok, dtype=torch.float32, device="cpu")
    image, mask = _image_mask(64, 64)
    rng = np.random.RandomState(3)
    pos, neg = (rng.randn(1, 77, 32).astype(np.float32) for _ in range(2))
    latents = rng.randn(1, H // 8, W // 8, 4).astype(np.float32)
    # the JAX pipeline's VAE sample noise of the masked image: fold 1 of the
    # image's key (the initial noise is replaced by ``latents``)
    vae_noise = torch.from_numpy(np.array(jax.random.normal(
        jax.random.fold_in(jax.random.PRNGKey(SEED), 1), (H // 8, W // 8, 4),
        jnp.float32))[None])
    monkeypatch.setattr(port_brushnet, "draw_noise",
                        lambda dev, seeds, shape, n: [torch.zeros(1, *shape),
                                                      vae_noise])
    seen = {"port": [], "jax": []}
    kw = dict(prompt="a red bench", task="object-removal", fitting_degree=0.6,
              guidance_scale=7.5, seed=SEED, latents=latents, height=H, width=W,
              timesteps=GRID, prompt_embeds=pos, negative_prompt_embeds=neg,
              callback_steps=2, output_type="float32")
    ip = dict(ip_adapter_image_embeds=rng.randn(DIM).astype(np.float32),
              ip_adapter_scale=0.8)
    want = jax_pipe(image, mask, callback=lambda i, x: seen["jax"].append(
        (int(i), np.array(x))), **kw, **ip)
    got = port(image, mask, callback=lambda i, x: seen["port"].append((i, x)),
               **kw, **ip)
    assert got.shape == np.asarray(want).shape == (1, H, W, 3)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-3)
    assert np.abs(port(image, mask, **kw) - got).max() > 1e-2  # the adapter
    to_u8 = lambda x: np.round(np.clip(np.asarray(x) / 2 + 0.5, 0, 1) * 255)  # noqa: E731
    d = np.abs(to_u8(got) - to_u8(want))
    assert d.max() <= 1, (d.max(), d.mean())
    assert [i for i, _ in seen["port"]] == [i for i, _ in seen["jax"]] == [0, 2, 4]
    for (_, a), (_, b) in zip(seen["port"], seen["jax"]):
        assert a.shape == b.shape == (1, H // 8, W // 8, 4)
        # 1e-4 of the largest magnitude: the random tiny UNet at guidance
        # 7.5 drives the latents to about 20, where fp32 steps are 2e-6
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(b).max()))
    # the JAX package's refusal of timesteps= with another sampler, before
    # any device work, is the port's
    errors = []
    for pipe in (port, jax_pipe):
        with pytest.raises(ValueError) as exc:
            pipe(image, mask, prompt="x", timesteps=GRID, scheduler="ddim")
        errors.append((type(exc.value).__name__, str(exc.value)))
    assert errors[0] == errors[1]
    assert errors[0][0] == jax_validation.InputValidationError.__name__


# ---------------------------------------------------------------------------
# the port's own checks
# ---------------------------------------------------------------------------


def _capture_pair(pipe, name):
    """Wrap ``_encode_prompts`` to keep the (negative, positive) pair the
    branch (v2) or the UNet (v1, ControlNet) is conditioned on."""
    box, inner = {}, pipe._encode_prompts

    def wrapped(*a, **kw):
        out = inner(*a, **kw)
        cond = out[0] if name == "v2" else out
        b = cond.shape[0] // 2
        box["neg"], box["pos"] = cond[:b].numpy(), cond[b:].numpy()
        return out

    return box, wrapped


@pytest.mark.parametrize("name", ["v1", "v2", "cn"])
def test_given_embeds_skip_the_encoder(port_pipes, monkeypatch, name):
    """The pipeline's own pair handed back as numpy fp32 gives the image
    bitwise, with the text encoder (v1, ControlNet) or the task tower (v2)
    not called; the v2 plain tower still runs."""
    pipe = port_pipes[name]
    image, mask = _image_mask()
    extra = {"control_image": _image_mask(seed=5)[0]} if name == "cn" else {}
    kw = dict(prompt="a dog", negative_prompt="blurry", fitting_degree=0.7,
              num_inference_steps=2, seed=3, **extra)
    box, wrapped = _capture_pair(pipe, name)
    monkeypatch.setattr(pipe, "_encode_prompts", wrapped)
    want = pipe(image, mask, **kw)
    tower = pipe.text_encoder_brushnet if name == "v2" else pipe.text_encoder
    calls = []
    monkeypatch.setattr(tower, "forward", lambda *a, **k: calls.append(1))
    if name == "v2":
        plain, inner = [], pipe.text_encoder.forward
        monkeypatch.setattr(pipe.text_encoder, "forward",
                            lambda *a, **k: plain.append(1) or inner(*a, **k))
    got = pipe(image, mask, prompt_embeds=box["pos"],
               negative_prompt_embeds=box["neg"], **kw)
    np.testing.assert_array_equal(got, want)
    assert calls == []
    if name == "v2":
        assert plain == [1]
    # one of the two given: the encoder runs and the other half is replaced
    monkeypatch.undo()
    half = pipe(image, mask, prompt_embeds=box["pos"], **kw)
    np.testing.assert_array_equal(half, want)


@pytest.mark.parametrize("name", ["v1", "v2", "cn"])
def test_callback_sees_copies(port_pipes, name):
    """The callback's arrays are copies: writing into them changes neither
    the run nor the arrays of other steps; ``callback_steps=0`` is clamped
    to every step."""
    pipe = port_pipes[name]
    image, mask = _image_mask()
    extra = {"control_image": _image_mask(seed=5)[0]} if name == "cn" else {}
    kw = dict(prompt="a dog", num_inference_steps=3, seed=3, **extra)
    want = pipe(image, mask, **kw)
    seen = []

    def vandal(i, latents):
        seen.append((i, latents.copy()))
        latents[...] = 1e6

    got = pipe(image, mask, callback=vandal, callback_steps=0, **kw)
    np.testing.assert_array_equal(got, want)
    assert [i for i, _ in seen] == [0, 1, 2]
    assert all(np.abs(x).max() < 1e3 for _, x in seen)
    assert not np.array_equal(seen[0][1], seen[1][1])
    # the callback is per call: the next call without one runs none
    again = pipe(image, mask, **kw)
    np.testing.assert_array_equal(again, want)
    assert len(seen) == 3


def test_step_callback_is_the_default(tok):
    """``step_callback`` at construction runs on every call that passes no
    callback, as the JAX package's field does."""
    cfg = tiny_v1_config()
    state = init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    seen = []
    pipe = InpaintPipeline(cfg, state, tok, dtype=torch.float32, device="cpu",
                           step_callback=lambda i, x: seen.append(i))
    image, mask = _image_mask()
    pipe(image, mask, prompt="x", num_inference_steps=2)
    assert seen == [0, 1]
    pipe(image, mask, prompt="x", num_inference_steps=3, callback_steps=2,
         callback=lambda i, x: seen.append(-i))
    assert seen == [0, 1, 0, -2]


@pytest.mark.parametrize("scheduler", ["ddim", "euler_a", "lcm"])
def test_timesteps_with_another_sampler_is_refused(port_pipes, monkeypatch,
                                                   scheduler):
    pipe = port_pipes["v2"]
    monkeypatch.setattr(pipe, "_generate", None)  # any device work fails
    image, mask = _image_mask()
    with pytest.raises(InputValidationError, match="only supported with the "
                       "unipc scheduler"):
        pipe(image, mask, prompt="x", timesteps=GRID, scheduler=scheduler)
    with pytest.raises(InputValidationError, match="strictly descending"):
        pipe(image, mask, prompt="x", timesteps=[10, 20])


def test_custom_grid_runs_its_evaluations(port_pipes):
    """``timesteps=`` sets the UNet evaluations to the list's length and
    the sampler's timesteps to the list, whatever num_inference_steps
    says."""
    pipe = port_pipes["v2"]
    seen, inner = [], pipe.unet.forward

    def counted(x, t, *a, **kw):
        seen.append(int(t))
        return inner(x, t, *a, **kw)

    pipe.unet.forward = counted
    try:
        image, mask = _image_mask()
        out = pipe(image, mask, prompt="x", timesteps=GRID,
                   num_inference_steps=45)
    finally:
        del pipe.unet.forward
    assert seen == GRID and out.shape == (1, 64, 64, 3)
