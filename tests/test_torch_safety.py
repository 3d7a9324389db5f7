"""The port's CLIP vision tower and safety checker against the JAX
package's, in fp32 at the tiny CLIP tower, and the checker and the
annotators wired into ``PowerPaint.infer``.

One set of weights: the port's random state with every entry but the
thresholds moved by N(0, 0.05), made a JAX tree by the JAX package's
``convert_clip_vision`` / ``convert_safety_checker`` and carried back by
``params_from_jax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powerpaint_tpu.core import safety as jax_safety
from powerpaint_tpu.core.config import CLIPVisionConfig as JaxCLIPVisionConfig
from powerpaint_tpu.io.convert import convert_clip_vision, convert_safety_checker
from powerpaint_tpu.models.clip_vision import CLIPVisionModel as JaxVisionModel
from powerpaint_tpu.models.clip_vision import (
    CLIPVisionModelWithProjection as JaxTower,
)
from powerpaint_tpu.models.clip_vision import (
    StableDiffusionSafetyChecker as JaxChecker,
)
from powerpaint_tpu_torch import controller
from powerpaint_tpu_torch.core import safety
from powerpaint_tpu_torch.core.validation import (
    InputValidationError,
    check_control_image,
)
from powerpaint_tpu_torch.io.weights import (
    init_state,
    load_annotator,
    params_from_jax,
    random_annotator_state,
)
from powerpaint_tpu_torch.models.clip_vision import CLIPVisionModel
from powerpaint_tpu_torch.pipelines.inpaint import InpaintPipeline
from powerpaint_tpu_torch.tasks import control
from powerpaint_tpu_torch.testing import tiny_clip_vision_config, tiny_v1_config
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


CFG = tiny_clip_vision_config()
JAX_CFG = JaxCLIPVisionConfig(**CFG.to_dict())


def _weights(family, convert, seed=0):
    rng = np.random.RandomState(seed)
    sd = {k: v.numpy() + (0 if k.endswith("embeds_weights") else
                          0.05 * rng.randn(*v.shape).astype(np.float32))
          for k, v in random_annotator_state(
              family, torch.Generator().manual_seed(seed), device="cpu",
              config=CFG).items()}
    tree = jax.tree.map(jnp.asarray, convert(sd))
    return tree, params_from_jax(jax.tree.map(np.asarray, tree), family)


@pytest.fixture(scope="module")
def checker_weights():
    return _weights("safety_checker", convert_safety_checker)


_jax_checker = jax.jit(lambda p, x: JaxChecker(
    JAX_CFG, num_concepts=17, num_special=3, dtype=jnp.float32).apply(
        {"params": p}, x))


def test_clip_vision_matches_jax():
    """The tower's hidden states and pooled class token
    (``CLIPVisionModel``), and the projected image embedding."""
    tree, sd = _weights("clip_vision", convert_clip_vision)
    assert "vision_model.embeddings.class_embedding" in sd
    pix = np.random.RandomState(1).randn(2, 32, 32, 3).astype(np.float32)
    want = np.asarray(jax.jit(JaxTower(JAX_CFG, dtype=jnp.float32).apply)(
        {"params": tree}, jnp.asarray(pix)))
    want_hidden, want_pooled = jax.jit(JaxVisionModel(JAX_CFG, dtype=jnp.float32).apply)(
        {"params": tree["vision_model"]}, jnp.asarray(pix))
    model = load_annotator("clip_vision", sd, config=CFG, device="cpu")
    tower = CLIPVisionModel(CFG)
    tower.vision_model = model.vision_model
    with torch.no_grad():
        got = model(torch.from_numpy(pix)).numpy()
        hidden, pooled = tower(torch.from_numpy(pix))
    assert got.shape == want.shape == (2, 16)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)
    assert hidden.shape == want_hidden.shape == (2, 17, 32)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(want_hidden), atol=2e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want_pooled), atol=2e-5,
                               rtol=1e-5)


def test_safety_flags_match_jax_under_forced_thresholds(checker_weights):
    """Concept tables built around image 0's own embedding: flagged where a
    cosine beats its threshold, not where every threshold is above 1, and
    the special-care adjustment of 0.01 deciding a threshold of 1.005."""
    tree, sd = checker_weights
    model = load_annotator("safety_checker", sd, config=CFG, device="cpu")
    pix = np.random.RandomState(2).randn(2, 32, 32, 3).astype(np.float32)
    x = torch.from_numpy(pix)
    with torch.no_grad():
        emb = model.visual_projection(model.vision_model(x)[1])[0].numpy()
    e0 = emb / np.linalg.norm(emb)
    other = np.roll(e0, 1)
    cases = [  # concepts, their thresholds, special rows, theirs, expected
        ([e0, -e0, other], [0.5, 0.5, 2.0], [-e0, -e0, -e0], [2.0] * 3, [True, False]),
        ([e0, -e0, other], [1.5, 1.5, 2.0], [-e0, -e0, -e0], [2.0] * 3, [False, False]),
        ([e0, -e0, other], [1.005, 2.0, 2.0], [-e0, -e0, -e0], [2.0] * 3, [False, False]),
        ([e0, -e0, other], [1.005, 2.0, 2.0], [e0, -e0, -e0], [0.5, 2.0, 2.0],
         [True, False]),
    ]
    for concepts, c_w, special, s_w, expected in cases:
        concepts = np.stack(concepts + [other] * 14).astype(np.float32)
        c_w = np.asarray(c_w + [2.0] * 14, np.float32)
        forced = dict(concept_embeds=concepts, concept_embeds_weights=c_w,
                      special_care_embeds=np.stack(special).astype(np.float32),
                      special_care_embeds_weights=np.asarray(s_w, np.float32))
        with torch.no_grad():
            for k, v in forced.items():
                getattr(model, k).copy_(torch.from_numpy(v))
            got = model(x).tolist()
        want = np.asarray(_jax_checker(dict(tree, **forced), jnp.asarray(pix)))
        assert got == want.tolist()
        assert got[0] == expected[0]


def test_clip_safety_checker_matches_jax(checker_weights):
    """uint8 images of another size, end to end: the same CLIP pixels, the
    same flags; thresholds above 1 flag nothing, thresholds of -2 flag
    every image and black it out. (At the tiny tower's 16-d projection the
    random state's thresholds of about 0.2 sit inside the spread of random
    cosines; at 768-d they do not.)"""
    tree, sd = checker_weights
    images = (np.random.RandomState(0).rand(3, 48, 40, 3) * 255).astype(np.uint8)
    none = dict(sd, concept_embeds_weights=np.full(17, 1.5, np.float32),
                special_care_embeds_weights=np.full(3, 1.5, np.float32))
    jax_none = {**tree, **{k: jnp.asarray(none[k]) for k in (
        "concept_embeds_weights", "special_care_embeds_weights")}}
    ours = safety.CLIPSafetyChecker(CFG, none, device="cpu")
    theirs = jax_safety.CLIPSafetyChecker(JAX_CFG, jax_none)
    from PIL import Image

    np.testing.assert_array_equal(ours.preprocess(images), np.stack([
        (np.asarray(Image.fromarray(i).resize((32, 32), Image.BICUBIC),
                    np.float32) / 255.0 - jax_safety._CLIP_MEAN)
        / jax_safety._CLIP_STD for i in images]))
    assert ours(images) == theirs(images) == [False] * 3
    flag_all = dict(sd, concept_embeds_weights=np.full(17, -2.0, np.float32))
    jax_flag_all = dict(tree, concept_embeds_weights=jnp.full((17,), -2.0))
    ours = safety.CLIPSafetyChecker(CFG, flag_all, device="cpu")
    theirs = jax_safety.CLIPSafetyChecker(JAX_CFG, jax_flag_all)
    assert ours(images) == theirs(images) == [True] * 3
    out, flags = safety.apply_safety_checker(images, ours)
    assert flags == [True] * 3 and not out.any()


@pytest.fixture(scope="module")
def v1_pipe():
    state = init_state(tiny_v1_config(), torch.Generator().manual_seed(0),
                       device="cpu")
    tok = TokenizerWrapper(HashTokenizer(994))
    add_task_tokens(tok)
    return InpaintPipeline(tiny_v1_config(), state, tok, dtype=torch.float32,
                           device="cpu")


def test_infer_blacks_out_a_flagged_image(v1_pipe, checker_weights):
    """The registered checker on the tiny ppt-v1 stack: thresholds of 1.5
    pass the image, thresholds of -1 flag it and ``infer`` returns it
    black."""
    _, sd = checker_weights
    rng = np.random.RandomState(3)
    image = (rng.rand(64, 64, 3) * 255).astype(np.uint8)
    mask = np.zeros((64, 64), np.float32)
    mask[16:48, 16:48] = 1.0
    kw = dict(prompt="a dog", num_inference_steps=2, seed=1)
    try:
        for weights, flagged in ((-1.0, True), (1.5, False)):
            state = dict(sd, concept_embeds_weights=np.full(17, weights, np.float32))
            safety.register_safety_checker(
                safety.CLIPSafetyChecker(CFG, state, device="cpu"))
            res = controller.PowerPaint(v1_pipe).infer(image, mask, **kw)
            assert res.nsfw_flags == [flagged]
            assert res.raw.shape == (64, 64, 3)
            assert (not res.raw.any()) == flagged
    finally:
        safety.register_safety_checker(None)


class StubPipeline:
    """Records the control image it is handed; returns a fixed image."""

    def __init__(self):
        self.controls = []

    def __call__(self, image, mask, control_image=None, **kw):
        self.controls.append(control_image)
        return np.full((1,) + image.shape, 77, np.uint8)


def test_infer_resizes_a_generated_control_map():
    """A preprocessor's map at its own size (depth's 1024^2 output against
    a 64^2 image) reaches the ControlNet pipeline at the image's size, as
    the reference resizes it; the map as it came would fail the pipeline's
    check. A control image the caller passes at neither the input nor the
    processed size is refused, naming both (ROADMAP C1)."""
    image = (np.random.RandomState(4).rand(64, 64, 3) * 255).astype(np.uint8)
    mask = np.ones((64, 64), np.float32)
    big = (np.indices((128, 128)).sum(0) % 5 == 0)[..., None].repeat(3, -1)
    big = big.astype(np.uint8) * 255
    with pytest.raises(InputValidationError):
        check_control_image(big, image)
    control.register_preprocessor("depth", lambda img: big)
    try:
        cn = StubPipeline()
        controller.PowerPaint(StubPipeline(), controlnet_pipeline=cn).infer(
            image, mask, control_type="depth", num_inference_steps=2)
    finally:
        del control._REGISTRY["depth"]
    from PIL import Image

    want = np.asarray(Image.fromarray(big).resize((64, 64), Image.LANCZOS))
    np.testing.assert_array_equal(cn.controls[0], want)
    cn = StubPipeline()
    with pytest.raises(InputValidationError,
                       match=r"control image \(128, 128\) matches neither the "
                             r"input image \(64, 64\) nor the processed image "
                             r"\(64, 64\)"):
        controller.PowerPaint(StubPipeline(), controlnet_pipeline=cn).infer(
            image, mask, control_type="depth", control_image=big,
            num_inference_steps=2)
    assert cn.controls == []


@pytest.mark.parametrize("task,kw", [
    ("text-guided", dict(short_side=500, resolution_bucketing=True)),
    ("text-guided", dict(short_side=640)),
    ("image-outpainting", dict(horizontal_expansion_ratio=1.5,
                               resolution_bucketing=True))],
    ids=["resize+crop+bucket", "crop", "outpaint+bucket"])
def test_infer_aligns_a_given_control_map(task, kw):
    """ROADMAP C1: a caller's map at the input image's size goes through
    the image's own resize, canvas, crop and bucket pad (the image itself
    as the map comes out as the processed image, bitwise; a map of lines
    as those steps make it); at the processed size it passes as it is; at
    any other size the call is refused."""
    from powerpaint_tpu.tasks import preprocess as jax_pre

    rng = np.random.RandomState(5)
    image = (rng.rand(700, 530, 3) * 255).astype(np.uint8)
    mask = np.zeros((700, 530), np.float32)
    mask[200:450, 100:300] = 1.0
    lines = (np.indices((700, 530)).sum(0) % 11 == 0)[..., None].repeat(3, -1)
    lines = lines.astype(np.uint8) * 255

    def run(control):
        cn, seen = StubPipeline(), []

        def record(img, msk, **k):  # the image the pipeline is handed too
            seen.append(img)
            return cn(img, msk, **k)

        controller.PowerPaint(StubPipeline(), controlnet_pipeline=record).infer(
            image, mask, task=task, control_type="canny",
            control_image=control, num_inference_steps=2, **kw)
        return seen[0], cn.controls[0]

    img, ctrl = run(image)
    np.testing.assert_array_equal(ctrl, img)
    _, ctrl = run(lines)
    want = lines
    target = 512 if task == "image-outpainting" else kw["short_side"]
    if min(want.shape[:2]) > target:
        want = jax_pre.resize_short_side(want, target)
    if task == "image-outpainting":
        want = jax_pre.outpaint_canvas(want, 1.5, 1.0)[0]
    want = jax_pre.crop_to_multiple_of_8(want)
    if kw.get("resolution_bucketing"):
        want = jax_pre.pad_to_bucket(want, np.zeros(want.shape[:2]))[0]
    assert ctrl.shape == img.shape
    np.testing.assert_array_equal(ctrl, want)
    processed = (rng.rand(*img.shape) * 255).astype(np.uint8)
    _, ctrl = run(processed)
    np.testing.assert_array_equal(ctrl, processed)
    with pytest.raises(InputValidationError, match="matches neither"):
        run(lines[:640, :480])
