"""The port's ``ControlNetPipeline`` against the JAX package's, end to end.

Tiny ppt-v1 + ControlNet configuration in fp32, a 64x64 image and a drawn
edge map, the same weights on both sides (the port's random init, zero
convs included, through the JAX package's converters). The JAX pipeline
draws its noise from per-image threefry streams; the test hands the same
streams to the port's ``_generate`` with the port's gating table. The
uint8 images must agree within the JAX package's end-to-end oracle bound
(max 3, mean 0.5): the four tasks with one branch (one JAX compile), and
two branches in guess mode with a guidance window (the other). The likely
wiring faults must move the port's image by more than that bound.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powerpaint_tpu.pipelines.controlnet import ControlNetPipeline as JaxPipeline
from powerpaint_tpu.testing import (
    tiny_v1_controlnet_config as jax_tiny_v1_controlnet_config,
)
from powerpaint_tpu_torch.pipelines.controlnet import (
    ControlNetPipeline,
    gating_table,
)
from powerpaint_tpu_torch.pipelines.inpaint import InpaintPipeline
from powerpaint_tpu_torch.testing import (
    tiny_v1_config,
    tiny_v1_controlnet_config,
)
from powerpaint_tpu_torch.text.prompts import TASKS, add_task
from powerpaint_tpu_torch.text.tokenizer import (
    HashTokenizer,
    TokenizerWrapper,
    add_task_tokens,
)
from test_torch_controlnet import cn_weights
from test_torch_pipeline import _jax_noise


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
PROMPT = "a red bench"
# the two-branch call: guess mode, per-branch scales and windows
MULTI = dict(num_inference_steps=4, guess_mode=True,
             controlnet_conditioning_scale=[1.0, 0.7],
             control_guidance_start=[0.0, 0.25],
             control_guidance_end=[1.0, 0.5])


def _tok():
    tok = TokenizerWrapper(HashTokenizer(994))
    add_task_tokens(tok)
    return tok


@pytest.fixture(scope="module")
def weights():
    sd_a, trees_a = cn_weights(0)
    sd_b, trees_b = cn_weights(1)
    return sd_a, trees_a, sd_b["controlnet"], trees_b["controlnet"]


@pytest.fixture(scope="module")
def port(weights):
    sd, *_ = weights
    return ControlNetPipeline(tiny_v1_controlnet_config(), sd, _tok(),
                              dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def port_two(weights):
    sd, _, sd_b, _ = weights
    return ControlNetPipeline(tiny_v1_controlnet_config(),
                              dict(sd, controlnet=[sd["controlnet"], sd_b]),
                              _tok(), dtype=torch.float32, device="cpu")


def _inputs():
    rng = np.random.RandomState(0)
    image = (rng.rand(HW, HW, 3) * 255).astype(np.uint8)
    mask = np.zeros((HW, HW), np.float32)
    mask[13:50, 10:45] = 1.0  # edges off the 8-pixel grid
    yy, xx = np.mgrid[:HW, :HW]
    ring = np.abs(np.hypot(yy - 30, xx - 34) - 17) < 1.2
    box = np.zeros((HW, HW), bool)
    box[8:56, 6] = box[8:56, 57] = box[8, 6:58] = box[55, 6:58] = True
    edges = np.repeat(((ring | box) * 255).astype(np.uint8)[..., None], 3, -1)
    edges_b = np.ascontiguousarray(edges[::-1])
    return image, mask, edges, edges_b


@pytest.fixture(scope="module")
def jax_tasks(weights):
    """The JAX pipeline's image of each task, one branch (one compile)."""
    _, trees, _, _ = weights
    pipe = JaxPipeline(jax_tiny_v1_controlnet_config(), trees, _tok(),
                       dtype=jnp.float32)
    image, mask, edges, _ = _inputs()
    return {task: pipe(image, mask, control_image=edges, prompt=PROMPT,
                       task=task, fitting_degree=FIT, num_inference_steps=3,
                       guidance_scale=GUIDE, seed=SEED)
            for task in TASKS}


def _port_generate(pipe, task, controls, steps=3, guess_mode=False,
                   scales=1.0, starts=0.0, ends=1.0):
    image, mask, *_ = _inputs()
    (n0, nv, ni), _ = _jax_noise(SEED)
    n = len(controls)
    table = gating_table(steps, *(v if isinstance(v, list) else [v] * n
                                  for v in (scales, starts, ends)))
    ids = pipe.encode_task(add_task(PROMPT, "", task))[None]
    out = pipe._generate(
        torch.from_numpy(ids).long(), torch.tensor([FIT]),
        torch.from_numpy(image[None]),
        torch.from_numpy((mask >= 0.5).astype(np.uint8)[None, ..., None] * 255),
        torch.tensor([GUIDE]), n0, nv, ni, None, num_steps=steps,
        strength_steps=steps, output_type="uint8",
        control_u8=torch.from_numpy(np.stack(controls)[:, None]), scales=table,
        guess_mode=guess_mode)
    return out.numpy()


def _diff(got, want):
    d = np.abs(got.astype(np.int32) - np.asarray(want, np.int32))
    return d.max(), d.mean()


def _assert_close(got, want, msg):
    mx, mean = _diff(got, want)
    assert mx <= MAX_UINT8_DIFF and mean <= MEAN_UINT8_DIFF, (
        f"{msg}: max uint8 diff {mx}, mean {mean:.3f}")


@pytest.mark.parametrize("task", TASKS)
def test_tasks_match_jax(port, jax_tasks, task):
    _, _, edges, _ = _inputs()
    _assert_close(_port_generate(port, task, [edges]), jax_tasks[task], task)


def test_two_branches_guess_mode_window_match_jax(weights, port_two):
    _, trees, _, tree_b = weights
    params = dict(trees, controlnet=(trees["controlnet"], tree_b))
    jax_pipe = JaxPipeline(jax_tiny_v1_controlnet_config(), params, _tok(),
                           dtype=jnp.float32)
    image, mask, edges, edges_b = _inputs()
    want = jax_pipe(image, mask, control_image=[edges, edges_b], prompt=PROMPT,
                    fitting_degree=FIT, guidance_scale=GUIDE, seed=SEED,
                    **MULTI)
    got = _port_generate(
        port_two, "text-guided", [edges, edges_b],
        steps=MULTI["num_inference_steps"], guess_mode=True,
        scales=MULTI["controlnet_conditioning_scale"],
        starts=MULTI["control_guidance_start"],
        ends=MULTI["control_guidance_end"])
    _assert_close(got, want, "two branches, guess mode, window")
    # the second branch is live: without it the image moves past the bound
    one = _port_generate(port_two, "text-guided", [edges, edges_b], steps=4,
                         guess_mode=True, scales=[1.0, 0.0])
    assert max(_diff(one, want)[0] - MAX_UINT8_DIFF,
               _diff(one, want)[1] - MEAN_UINT8_DIFF) > 0


def _fails_bound(got, want):
    mx, mean = _diff(got, want)
    return mx > MAX_UINT8_DIFF or mean > MEAN_UINT8_DIFF


def test_control_image_in_minus_one_to_one_fails_the_bound(port, jax_tasks,
                                                           monkeypatch):
    """Negative control: the control image scaled to [-1, 1] (the latents'
    range) instead of [0, 1]."""
    _, _, edges, _ = _inputs()
    residuals = port._residuals
    monkeypatch.setattr(port, "_residuals",
                        lambda i, lat, t, cond, control, *a: residuals(
                            i, lat, t, cond, control * 2.0 - 1.0, *a))
    got = _port_generate(port, "text-guided", [edges])
    assert _fails_bound(got, jax_tasks["text-guided"])


def test_residuals_in_reverse_order_fail_the_bound(port, jax_tasks,
                                                   monkeypatch):
    """Negative control: the down residuals added to the skips in reverse
    order within each run of equal shapes (the only reversal the shapes
    allow)."""
    _, _, edges, _ = _inputs()
    residuals = port._residuals

    def reversed_runs(*args):
        kw = residuals(*args)
        down, out, run = kw["down_block_additional_residuals"], [], []
        for r in down + [None]:
            if run and (r is None or r.shape != run[0].shape):
                out.extend(run[::-1])
                run = []
            run.append(r)
        assert len(out) == len(down)
        assert any(a is not b for a, b in zip(out, down))
        return dict(kw, down_block_additional_residuals=out)

    monkeypatch.setattr(port, "_residuals", reversed_runs)
    got = _port_generate(port, "text-guided", [edges])
    assert _fails_bound(got, jax_tasks["text-guided"])


def test_no_control_image_is_the_v1_pipeline(weights, port):
    sd, *_ = weights
    v1 = InpaintPipeline(tiny_v1_config(),
                         {k: v for k, v in sd.items() if k != "controlnet"},
                         _tok(), dtype=torch.float32, device="cpu")
    image, mask, _, _ = _inputs()
    kw = dict(prompt=PROMPT, num_inference_steps=2, seed=3,
              fitting_degree=FIT)
    np.testing.assert_array_equal(port(image, mask, None, **kw),
                                  v1(image, mask, **kw))


def test_batched_matches_alone(port):
    image, mask, edges, edges_b = _inputs()
    kw = dict(num_inference_steps=2, fitting_degree=FIT)
    a = port(image, mask, edges, prompt=PROMPT, seed=3, **kw)
    b = port(image, mask, edges_b, prompt="a dog", seed=9, **kw)
    both = port(image, mask, [edges, edges_b], prompt=[PROMPT, "a dog"],
                seed=[3, 9], **kw)
    assert both.shape == (2, HW, HW, 3) and a.shape == (1, HW, HW, 3)
    assert np.abs(both[0].astype(int) - a[0].astype(int)).max() <= 1
    assert np.abs(both[1].astype(int) - b[0].astype(int)).max() <= 1
    np.testing.assert_array_equal(
        port(image, mask, edges, prompt=PROMPT, seed=3, **kw), a)
    assert not np.array_equal(
        port(image, mask, edges, prompt=PROMPT, seed=4, **kw), a)
    two = port(image, mask, edges, prompt=PROMPT, seed=3,
               num_images_per_prompt=2, **kw)
    assert np.abs(two[0].astype(int) - a[0].astype(int)).max() <= 1


def test_batched_euler_a_matches_each_request_alone(port):
    """A stochastic sampler's step noise comes from each image's own
    generator: a two-request batch with a control image each gives each
    request's standalone image (fp32 on the CPU, max 1 uint8 level)."""
    image, mask, edges, edges_b = _inputs()
    kw = dict(num_inference_steps=3, scheduler="euler_a", fitting_degree=FIT)
    both = port(image, mask, [edges, edges_b], prompt=[PROMPT, "a dog"],
                seed=[3, 9], **kw)
    alone = [port(image, mask, edges, prompt=PROMPT, seed=3, **kw),
             port(image, mask, edges_b, prompt="a dog", seed=9, **kw)]
    for got, want in zip(both, alone):
        assert np.abs(got.astype(int) - want[0].astype(int)).max() <= 1
    assert not np.array_equal(
        alone[0], port(image, mask, edges, prompt=PROMPT, seed=4, **kw))
