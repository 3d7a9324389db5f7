"""The port's ``InpaintPipeline`` against the JAX package's, end to end.

Tiny ppt-v1 configuration in fp32, a 64x64 image, the same weights on both
sides (the port's random init through the JAX package's converter). The
JAX pipeline draws its noise from per-image threefry streams; the test
computes those streams as the JAX pipeline does and hands them to the
port's ``_generate``. The uint8 images must agree within the JAX package's
end-to-end oracle bound (max 3, mean 0.5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powerpaint_tpu.io.convert import convert_clip_text, convert_unet, convert_vae
from powerpaint_tpu.pipelines.inpaint import InpaintPipeline as JaxPipeline
from powerpaint_tpu.testing import tiny_v1_config as jax_tiny_v1_config
from powerpaint_tpu_torch.core.validation import InputValidationError
from powerpaint_tpu_torch.io.weights import init_state
from powerpaint_tpu_torch.pipelines.inpaint import InpaintPipeline
from powerpaint_tpu_torch.testing import tiny_v1_config
from powerpaint_tpu_torch.text.prompts import TASKS, add_task
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


HW, SEED, FIT, GUIDE = 64, 7, 0.6, 7.5
MAX_UINT8_DIFF, MEAN_UINT8_DIFF = 3, 0.5


@pytest.fixture(scope="module")
def pipes():
    state = init_state(tiny_v1_config(), torch.Generator().manual_seed(0),
                       device="cpu")
    rng = np.random.RandomState(0)
    sd_np = {}
    for family, sd in state.items():
        sd_np[family] = {k: v.numpy() for k, v in sd.items()}
        for k, v in sd_np[family].items():  # random biases and norm affines
            if v.ndim == 1:
                sd_np[family][k] = (v + 0.1 * rng.randn(*v.shape)).astype(np.float32)
    tok = TokenizerWrapper(HashTokenizer(994))
    add_task_tokens(tok)
    params = {"unet": convert_unet(sd_np["unet"]),
              "vae": convert_vae(sd_np["vae"]),
              "text_encoder": convert_clip_text(sd_np["text_encoder"])}
    jax_pipe = JaxPipeline(jax_tiny_v1_config(), params, tok, dtype=jnp.float32)
    port = InpaintPipeline(tiny_v1_config(), sd_np, tok, dtype=torch.float32,
                           device="cpu")
    return jax_pipe, port


def _inputs():
    rng = np.random.RandomState(0)
    image = (rng.rand(HW, HW, 3) * 255).astype(np.uint8)
    mask = np.zeros((HW, HW), np.float32)
    # edges off the 8-pixel grid: the latent mask then depends on the
    # half-pixel-centre nearest resize of jax.image.resize
    mask[13:50, 10:45] = 1.0
    return image, mask


def _jax_noise(seed, n_steps=0):
    """The JAX pipeline's per-image streams (pipelines/inpaint.py:354-391):
    folds 0, 1, 2 of the image's key are the initial latent noise and the
    two VAE sample noises; with eta > 0, fold 3 of the first image's key
    seeds one draw per step."""
    key = jax.random.PRNGKey(seed)
    h8 = HW // 8
    draws = [torch.from_numpy(np.array(jax.random.normal(
        jax.random.fold_in(key, f), (h8, h8, 4), jnp.float32))[None])
        for f in (0, 1, 2)]
    eta_key = jax.random.fold_in(key, 3)
    steps = [torch.from_numpy(np.array(jax.random.normal(
        jax.random.fold_in(eta_key, i), (1, h8, h8, 4), jnp.float32)))
        for i in range(n_steps)]
    return draws, steps


def _jax_step_noise(seed, n_iterations):
    """A stochastic sampler's step noise in the JAX pipeline
    (pipelines/inpaint.py:365-370, :222-229): fold 4 of the image's key,
    then fold i for iteration i."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 4)
    return [torch.from_numpy(np.array(jax.random.normal(
        jax.random.fold_in(key, i), (HW // 8, HW // 8, 4), jnp.float32))[None])
        for i in range(n_iterations)]


def _port_generate(port, task, steps, strength=1.0, eta=0.0, scheduler="ddim"):
    image, mask = _inputs()
    kept = min(int(steps * strength), steps)
    (n0, nv, ni), step_noise = _jax_noise(SEED, kept if eta > 0 else 0)
    if scheduler != "ddim":  # euler_a: one draw an iteration, one a step
        step_noise = _jax_step_noise(SEED, kept)
    ids = port.encode_task(add_task("a red bench", "", task))[None]
    out = port._generate(
        torch.from_numpy(ids).long(), torch.tensor([FIT]),
        torch.from_numpy(image[None]),
        torch.from_numpy((mask >= 0.5).astype(np.uint8)[None, ..., None] * 255),
        torch.tensor([GUIDE]), n0, nv, ni, step_noise,
        num_steps=steps, strength_steps=kept, output_type="uint8", eta=eta,
        scheduler=scheduler)
    return out.numpy()


def _assert_close(got, want, msg):
    d = np.abs(got.astype(np.int32) - np.asarray(want, np.int32))
    assert d.max() <= MAX_UINT8_DIFF and d.mean() <= MEAN_UINT8_DIFF, (
        f"{msg}: max uint8 diff {d.max()}, mean {d.mean():.3f}")


@pytest.mark.parametrize("task", TASKS)
def test_tasks_match_jax(pipes, task):
    jax_pipe, port = pipes
    image, mask = _inputs()
    want = jax_pipe(image, mask, prompt="a red bench", task=task,
                    fitting_degree=FIT, num_inference_steps=3,
                    guidance_scale=GUIDE, seed=SEED)
    _assert_close(_port_generate(port, task, 3), want, task)


@pytest.mark.parametrize("kw", [dict(strength=0.6), dict(eta=0.5)],
                         ids=["strength", "eta"])
def test_strength_and_eta_match_jax(pipes, kw):
    jax_pipe, port = pipes
    image, mask = _inputs()
    want = jax_pipe(image, mask, prompt="a red bench", task="text-guided",
                    fitting_degree=FIT, num_inference_steps=5,
                    guidance_scale=GUIDE, seed=SEED, **kw)
    _assert_close(_port_generate(port, "text-guided", 5, **kw), want, str(kw))


def test_euler_a_with_strength_matches_jax(pipes):
    """A stochastic sigma-space sampler: the start is x0 + sigma * noise
    (strength 0.6), the UNet sees x / sqrt(sigma^2 + 1), and each step
    takes the JAX pipeline's fold-4 step noise."""
    jax_pipe, port = pipes
    image, mask = _inputs()
    want = jax_pipe(image, mask, prompt="a red bench", task="text-guided",
                    fitting_degree=FIT, num_inference_steps=5,
                    guidance_scale=GUIDE, seed=SEED, strength=0.6,
                    scheduler="euler_a")
    _assert_close(_port_generate(port, "text-guided", 5, strength=0.6,
                                 scheduler="euler_a"), want, "euler_a")


def test_call_surface(pipes):
    _, port = pipes
    image, mask = _inputs()
    kw = dict(num_inference_steps=2, fitting_degree=FIT)
    a = port(image, mask, prompt="a red bench", seed=3, **kw)
    assert a.shape == (1, HW, HW, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(port(image, mask, prompt="a red bench",
                                       seed=3, **kw), a)
    assert not np.array_equal(port(image, mask, prompt="a red bench", seed=4,
                                   **kw), a)
    # a batched request reproduces each standalone result
    both = port(image, mask, prompt=["a red bench", "a dog"], seed=[3, 9], **kw)
    alone = port(image, mask, prompt="a dog", seed=9, **kw)
    assert both.shape == (2, HW, HW, 3)
    assert np.abs(both[0].astype(int) - a.astype(int)).max() <= 1
    assert np.abs(both[1].astype(int) - alone.astype(int)).max() <= 1
    lat = port(image, mask, prompt="a red bench", output_type="latent", **kw)
    assert lat.shape == (1, HW // 8, HW // 8, 4) and lat.dtype == np.float32
    img = port(image, mask, prompt="a red bench", output_type="float32",
               num_images_per_prompt=2, **kw)
    assert img.shape == (2, HW, HW, 3) and np.isfinite(img).all()


@pytest.mark.parametrize("kw", [dict(task="paint"), dict(strength=0.0),
                                dict(output_type="pil"), dict(clip_skip=5),
                                dict(fitting_degree=1.5)])
def test_bad_arguments_raise_before_device_work(pipes, kw):
    _, port = pipes
    image, mask = _inputs()
    with pytest.raises(InputValidationError):
        port(image, mask, prompt="x", num_inference_steps=2, **kw)
