"""The port's ``BrushNetPipeline`` against the JAX package's, end to end.

Tiny ppt-v2 configuration in fp32, a 64x64 image, the same weights on both
sides (the port's random init, zero convs included, through the JAX
package's converters). The JAX pipeline draws its noise from per-image
threefry streams; the test computes those streams as the JAX pipeline
does and hands them to the port's ``_generate``. The uint8 images must
agree within the JAX package's end-to-end oracle bound (max 3, mean 0.5),
and the likely wiring faults must move the port's image by more than that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powerpaint_tpu.pipelines.brushnet import BrushNetPipeline as JaxPipeline
from powerpaint_tpu.testing import tiny_v2_config as jax_tiny_v2_config
from powerpaint_tpu_torch.core.validation import InputValidationError
from powerpaint_tpu_torch.pipelines.brushnet import (
    BrushNetPipeline,
    cond_scale_table,
)
from powerpaint_tpu_torch.testing import tiny_v2_config
from powerpaint_tpu_torch.text.prompts import TASKS, add_task, v2_prompt_suffix
from powerpaint_tpu_torch.text.tokenizer import (
    HashTokenizer,
    TokenizerWrapper,
    add_task_tokens,
)
from test_torch_brushnet import v2_weights


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are tiny, and the suite's parallel
    workers would otherwise oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HW, SEED, FIT, GUIDE, STEPS = 64, 7, 0.6, 7.5, 3
MAX_UINT8_DIFF, MEAN_UINT8_DIFF = 3, 0.5


@pytest.fixture(scope="module")
def pipes():
    sd_np, trees = v2_weights()
    tok = TokenizerWrapper(HashTokenizer(994))
    add_task_tokens(tok)
    jax_pipe = JaxPipeline(jax_tiny_v2_config(), trees, tok, dtype=jnp.float32)
    port = BrushNetPipeline(tiny_v2_config(), sd_np, tok, dtype=torch.float32,
                            device="cpu")
    return jax_pipe, port


def _inputs():
    rng = np.random.RandomState(0)
    image = (rng.rand(HW, HW, 3) * 255).astype(np.uint8)
    mask = np.zeros((HW, HW), np.float32)
    # edges off the 8-pixel grid: the latent keep mask then depends on the
    # half-pixel-centre nearest resize of jax.image.resize
    mask[13:50, 10:45] = 1.0
    return image, mask


def _jax_noise(seed):
    """The JAX pipeline's per-image streams (pipelines/brushnet.py:267-297):
    folds 0 and 1 of the image's key are the initial latent noise and the
    VAE sample noise of the masked image."""
    key = jax.random.PRNGKey(seed)
    return [torch.from_numpy(np.array(jax.random.normal(
        jax.random.fold_in(key, f), (HW // 8, HW // 8, 4), jnp.float32))[None])
        for f in (0, 1)]


def _port_generate(port, task, **kw):
    image, mask = _inputs()
    noise0, vae_noise = _jax_noise(SEED)
    ids_task, ids_plain = port.encode_task(
        add_task(v2_prompt_suffix("a red bench", task), "", task, "ppt-v2"))
    out = port._generate(
        torch.from_numpy(ids_task[None]).long(),
        torch.from_numpy(ids_plain[None]).long(), torch.tensor([FIT]),
        torch.from_numpy(image[None]),
        torch.from_numpy((mask >= 0.5).astype(np.uint8)[None, ..., None] * 255),
        torch.tensor([GUIDE]), cond_scale_table(STEPS, 1.0, 0.0, 1.0),
        noise0, vae_noise, num_steps=STEPS, output_type="uint8", **kw)
    return out.numpy()


def _diff(got, want):
    d = np.abs(got.astype(np.int32) - np.asarray(want, np.int32))
    return int(d.max()), float(d.mean())


@pytest.fixture(scope="module")
def jax_outputs(pipes):
    """One JAX compile serves the four tasks: the ids are runtime arrays."""
    jax_pipe, _ = pipes
    image, mask = _inputs()
    return {task: jax_pipe(image, mask, prompt="a red bench", task=task,
                           fitting_degree=FIT, num_inference_steps=STEPS,
                           guidance_scale=GUIDE, seed=SEED)
            for task in TASKS}


@pytest.mark.parametrize("task", TASKS)
def test_tasks_match_jax(pipes, jax_outputs, task):
    _, port = pipes
    mx, mean = _diff(_port_generate(port, task), jax_outputs[task])
    assert mx <= MAX_UINT8_DIFF and mean <= MEAN_UINT8_DIFF, (
        f"{task}: max uint8 diff {mx}, mean {mean:.3f}")


def _swap_text(port, monkeypatch):
    encode = port._encode_prompts
    monkeypatch.setattr(port, "_encode_prompts",
                        lambda *a, **k: tuple(reversed(encode(*a, **k))))


def _hole_mask_channel(port, monkeypatch):
    branch = port.brushnet.forward

    def forward(sample, t, ctx, cond, *a, **k):
        cond = torch.cat([cond[..., :4], 1.0 - cond[..., 4:]], dim=-1)
        return branch(sample, t, ctx, cond, *a, **k)

    monkeypatch.setattr(port.brushnet, "forward", forward)


@pytest.mark.parametrize("fault", [_swap_text, _hole_mask_channel],
                         ids=["task_and_plain_text_swapped",
                              "hole_mask_for_keep_mask"])
def test_the_check_catches_wiring_faults(pipes, jax_outputs, fault,
                                         monkeypatch):
    _, port = pipes
    fault(port, monkeypatch)
    mx, _ = _diff(_port_generate(port, "text-guided"),
                  jax_outputs["text-guided"])
    assert mx > MAX_UINT8_DIFF


def test_call_surface(pipes):
    _, port = pipes
    image, mask = _inputs()
    kw = dict(num_inference_steps=2, fitting_degree=FIT)
    a = port(image, mask, prompt="a red bench", seed=3, **kw)
    assert a.shape == (1, HW, HW, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(
        port(image, mask, prompt="a red bench", seed=3, **kw), a)
    assert not np.array_equal(
        port(image, mask, prompt="a red bench", seed=4, **kw), a)
    both = port(image, mask, prompt=["a red bench", "a dog"], seed=[3, 9], **kw)
    assert both.shape == (2, HW, HW, 3)
    assert np.abs(both[0].astype(int) - a.astype(int)).max() <= 1
    # the branch is alive, its gate and guess mode change the image
    off = port(image, mask, prompt="a red bench", seed=3,
               brushnet_conditioning_scale=0.0, **kw)
    gated = port(image, mask, prompt="a red bench", seed=3,
                 control_guidance_end=0.0, **kw)
    np.testing.assert_array_equal(off, gated)
    assert not np.array_equal(off, a)
    assert not np.array_equal(port(image, mask, prompt="a red bench", seed=3,
                                   guess_mode=True, **kw), a)
    lat = port(image, mask, prompt="a red bench", output_type="latent", **kw)
    assert lat.shape == (1, HW // 8, HW // 8, 4) and lat.dtype == np.float32


def test_lcm_unet_with_guidance_embedding_matches_jax():
    """An LCM-distilled UNet (``time_cond_proj_dim`` 8) at 4 LCM steps: the
    CFG-doubled guidance embedding of w - 1 reaches the UNet as
    ``timestep_cond`` and each step takes the JAX pipeline's fold-4 step
    noise (pipelines/brushnet.py:270-274, :298-310, :382-390). Guidance
    then changes the image beyond the CFG combine."""
    cfg = tiny_v2_config()
    cfg = cfg.replace(unet=cfg.unet.replace(time_cond_proj_dim=8))
    jax_cfg = jax_tiny_v2_config()
    jax_cfg = jax_cfg.replace(unet=jax_cfg.unet.replace(time_cond_proj_dim=8))
    sd_np, trees = v2_weights(cfg)
    assert trees["unet"]["time_embedding"]["cond_proj"]["kernel"].shape == (8, 32)
    tok = TokenizerWrapper(HashTokenizer(994))
    add_task_tokens(tok)
    image, mask = _inputs()
    want = JaxPipeline(jax_cfg, trees, tok, dtype=jnp.float32)(
        image, mask, prompt="a red bench", task="text-guided",
        fitting_degree=FIT, num_inference_steps=4, guidance_scale=5.0,
        seed=SEED, scheduler="lcm")
    port = BrushNetPipeline(cfg, sd_np, tok, dtype=torch.float32, device="cpu")
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), 4)
    step_noise = [torch.from_numpy(np.array(jax.random.normal(
        jax.random.fold_in(key, i), (HW // 8, HW // 8, 4), jnp.float32))[None])
        for i in range(4)]
    ids_task, ids_plain = port.encode_task(add_task(
        v2_prompt_suffix("a red bench", "text-guided"), "", "text-guided",
        "ppt-v2"))

    def generate(guidance):
        return port._generate(
            torch.from_numpy(ids_task[None]).long(),
            torch.from_numpy(ids_plain[None]).long(), torch.tensor([FIT]),
            torch.from_numpy(image[None]),
            torch.from_numpy((mask >= 0.5).astype(np.uint8)[None, ..., None] * 255),
            torch.tensor([guidance]), cond_scale_table(4, 1.0, 0.0, 1.0),
            *_jax_noise(SEED), step_noise, num_steps=4, output_type="uint8",
            scheduler="lcm").numpy()

    got = generate(5.0)
    mx, mean = _diff(got, want)
    assert mx <= MAX_UINT8_DIFF and mean <= MEAN_UINT8_DIFF, (
        f"lcm: max uint8 diff {mx}, mean {mean:.3f}")
    assert not np.array_equal(generate(9.0), got)


def test_cond_scale_table_gates_steps():
    np.testing.assert_array_equal(cond_scale_table(4, 0.5, 0.0, 0.5),
                                  [0.5, 0.5, 0.0, 0.0])
    np.testing.assert_array_equal(cond_scale_table(4, 1.0, 0.25, 1.0),
                                  [0.0, 1.0, 1.0, 1.0])


@pytest.mark.parametrize("kw", [
    dict(task="paint"), dict(output_type="pil"), dict(clip_skip=5),
    dict(fitting_degree=1.5), dict(control_guidance_start=0.8,
                                   control_guidance_end=0.2),
    dict(scheduler="karras"), dict(num_inference_steps=0)])
def test_bad_arguments_raise_before_device_work(pipes, kw, monkeypatch):
    _, port = pipes
    monkeypatch.setattr(port, "_generate", None)  # any device work fails
    image, mask = _inputs()
    kw = {"num_inference_steps": 2, **kw}
    with pytest.raises(InputValidationError):
        port(image, mask, prompt="x", **kw)
