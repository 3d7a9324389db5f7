"""The port's HED and OpenPose body annotators against the JAX package's, in
fp32: the two networks at 48 x 64, the PAF decode of a synthetic arm, and
the HED (plain, safe, scribble) and OpenPose preprocessors end to end
through OpenCV; then the same-size OpenCV resizes the HED shortcut skips,
and the control-type registry.

One set of weights per network: the port's random state at the published
width (lecun-normal weights, which keep 13 ReLU layers unsaturated as the
JAX package's test gets by shrinking torch's default init) with random
biases, made a JAX tree by the JAX package's ``convert_hed`` /
``convert_bodypose`` from the published names and carried back by
``params_from_jax``.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from powerpaint_tpu.io.convert import convert_bodypose, convert_hed
from powerpaint_tpu.models.annotators import BodyPoseModel as JaxBodyPose
from powerpaint_tpu.models.annotators import HEDNetwork as JaxHED
from powerpaint_tpu.tasks import control as jax_control
from powerpaint_tpu.tasks import pose as jax_pose
from powerpaint_tpu_torch.io.weights import (
    load_annotator,
    params_from_jax,
    random_annotator_state,
)
from powerpaint_tpu_torch.tasks import control, pose


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are tiny, and the suite's parallel
    workers would otherwise oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(family, convert, seed):
    """(JAX tree, port state dict): random biases on the port's state."""
    rng = np.random.RandomState(seed)
    sd = {}
    for k, v in random_annotator_state(family, torch.Generator().manual_seed(seed),
                                       device="cpu").items():
        v = v.numpy()
        sd[k] = v + 0.1 * rng.randn(*v.shape).astype(np.float32) \
            if k.endswith("bias") else v
    tree = jax.tree.map(jnp.asarray, convert(sd))
    return tree, params_from_jax(jax.tree.map(np.asarray, tree), family)


@pytest.fixture(scope="module")
def hed():
    return _weights("hed", convert_hed, 0)


@pytest.fixture(scope="module")
def body():
    return _weights("bodypose", convert_bodypose, 1)


def test_hed_matches_jax(hed):
    tree, sd = hed
    x = np.random.default_rng(0).random((1, 48, 64, 3), np.float32)
    want = np.asarray(jax.jit(JaxHED().apply)({"params": tree}, jnp.asarray(x)))
    with torch.no_grad():
        got = load_annotator("hed", sd, device="cpu")(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 48, 64, 1)
    assert 0.01 < want.std()  # edges vary: the network is not saturated
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_bodypose_matches_jax(body):
    tree, sd = body
    x = np.random.default_rng(2).random((1, 48, 64, 3), np.float32) - 0.5
    want = jax.jit(JaxBodyPose().apply)({"params": tree}, jnp.asarray(x))
    with torch.no_grad():
        got = load_annotator("bodypose", sd, device="cpu")(torch.from_numpy(x))
    for g, w, c in zip(got, want, (38, 19)):
        assert g.shape == w.shape == (1, 6, 8, c)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-4, rtol=1e-3)


def _gaussian_peak(shape, cx, cy, sigma=2.0):
    ys, xs = np.mgrid[: shape[0], : shape[1]]
    return np.exp(-((xs - cx) ** 2 + (ys - cy) ** 2) / (2 * sigma ** 2))


def test_paf_decode_matches_jax():
    """Neck -> right shoulder -> elbow -> wrist along a line, unit +x PAFs
    on each limb, and a second, disjoint arm: the same peaks, limbs,
    people and drawing as the JAX functions."""
    h, w = 64, 96
    heat = np.zeros((h, w, 19), np.float32)
    paf = np.zeros((h, w, 38), np.float32)
    for y, xs in ((20, {2: 16, 3: 32, 4: 48, 5: 64}),
                  (48, {2: 20, 6: 40, 7: 60, 8: 80})):
        for part, x in xs.items():
            heat[:, :, part - 1] += _gaussian_peak((h, w), x, y)
        for limb, chans in zip(pose.LIMB_SEQ, pose.MAP_IDX):
            if limb[0] in xs and limb[1] in xs:
                x0, x1 = sorted((xs[limb[0]], xs[limb[1]]))
                paf[y - 4:y + 4, x0:x1 + 1, chans[0] - 19] = 1.0
    peaks = pose.find_peaks(heat)
    assert peaks == jax_pose.find_peaks(heat)
    conns, special = pose.connect_limbs(paf, peaks, h)
    assert (conns, special) == jax_pose.connect_limbs(paf, peaks, h)
    cand, subset = pose.assemble_people(peaks, conns, special)
    want_cand, want_subset = jax_pose.assemble_people(peaks, conns, special)
    np.testing.assert_array_equal(cand, want_cand)
    np.testing.assert_array_equal(subset, want_subset)
    assert len(subset) == 2 and (subset[:, -1] == 4).all()
    np.testing.assert_array_equal(pose.draw_bodypose(h, w, cand, subset),
                                  jax_pose.draw_bodypose(h, w, cand, subset))


def test_hed_preprocessor_matches_jax(hed):
    """Plain, safe and scribble at a 70 x 90 image (resized to the 64 x 64
    bucket and back through OpenCV): within one uint8 level."""
    tree, sd = hed
    image = (np.random.default_rng(1).random((70, 90, 3)) * 255).astype(np.uint8)
    theirs = jax_control.HEDPreprocessor(params=tree, detect_resolution=64)
    ours = control.HEDPreprocessor(state=sd, detect_resolution=64, device="cpu")
    for safe, scribble in ((False, False), (True, False), (False, True)):
        theirs.safe = ours.safe = safe
        theirs.scribble = ours.scribble = scribble
        want, got = theirs(image), ours(image)
        assert got.shape == want.shape == (70, 90, 3) and got.dtype == np.uint8
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, (safe, scribble)
        if scribble:
            assert set(np.unique(got)) <= {0, 255}


def test_openpose_preprocessor_matches_jax(body):
    """The network input, the fields and the drawn skeleton, end to end."""
    tree, sd = body
    image = (np.random.default_rng(3).random((96, 128, 3)) * 255).astype(np.uint8)
    theirs = jax_pose.OpenposeBodyPreprocessor(params=tree)
    ours = pose.OpenposeBodyPreprocessor(state=sd, device="cpu")
    x, scaled = ours.network_input(image)
    assert x.shape == (1, 184, 256, 3) and scaled == (184, 245)
    assert pose.network_shape(96, 128) == ((184, 245), (184, 256))
    paf, heat = ours.forward(x)
    want_paf, want_heat = theirs._apply(theirs.params, x)
    np.testing.assert_allclose(paf, np.asarray(want_paf[0]), atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(heat, np.asarray(want_heat[0]), atol=5e-4, rtol=1e-3)
    got, want = ours(image), theirs(image)
    assert got.shape == (96, 128, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", [(96, 128), (512, 512), (301, 517), (640, 427)])
def test_pose_network_shape_is_opencvs(hw):
    import cv2

    scale = 0.5 * pose.BOXSIZE / hw[0]
    scaled = cv2.resize(np.zeros(hw + (3,), np.uint8), (0, 0), fx=scale,
                        fy=scale, interpolation=cv2.INTER_CUBIC)
    (h, w), (hp, wp) = pose.network_shape(*hw)
    assert scaled.shape[:2] == (h, w)
    assert hp % 8 == 0 and wp % 64 == 0 and 0 <= hp - h < 8 and 0 <= wp - w < 64


@pytest.mark.parametrize("shape", [(512, 512, 3), (512, 512), (64, 192, 3), (7, 5)])
def test_same_size_opencv_resizes_are_the_identity(shape):
    """What the HED shortcut at an image already at its bucket's size
    relies on: INTER_AREA (the way in) and INTER_LINEAR (the way out) of
    uint8 at the same size change nothing."""
    import cv2

    x = (np.random.default_rng(4).random(shape) * 255).astype(np.uint8)
    for interp in (cv2.INTER_AREA, cv2.INTER_LINEAR):
        np.testing.assert_array_equal(
            cv2.resize(x, (shape[1], shape[0]), interpolation=interp), x)


def test_hed_at_its_bucket_size_needs_no_opencv(hed, monkeypatch):
    """At 64 x 64 with detect_resolution 64 (as 512 x 512 at the default)
    HED runs with OpenCV unimportable, and gives what the OpenCV path
    gives."""
    _, sd = hed
    image = (np.random.default_rng(5).random((64, 64, 3)) * 255).astype(np.uint8)
    pre = control.HEDPreprocessor(state=sd, detect_resolution=64, device="cpu")
    x = image.astype(np.float32)[None] / 255.0
    with torch.no_grad():
        edge = pre.model(torch.from_numpy(x))[0, :, :, 0].numpy()
    via_cv2 = (edge * 255.0).clip(0, 255).astype(np.uint8)
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = pre(image)
    np.testing.assert_array_equal(got[..., 0], via_cv2)


def test_annotators_raise_until_registered(hed):
    _, sd = hed
    image = np.zeros((64, 64, 3), np.uint8)
    for kind, register in (("depth", "register_dpt_depth"), ("hed", "register_hed"),
                           ("pose", "register_openpose")):
        control._REGISTRY.pop(kind, None)
        with pytest.raises(NotImplementedError, match=register):
            control.get_control_image(kind, image)
    pre = control.register_hed(state=sd, detect_resolution=64, device="cpu")
    try:
        np.testing.assert_array_equal(control.get_control_image("hed", image),
                                      pre(image))
    finally:
        del control._REGISTRY["hed"]
    with pytest.raises(NotImplementedError, match="unknown control type"):
        control.get_control_image("segmentation", image)


@pytest.fixture(autouse=True, scope="module")
def jax_preprocessors():
    """The JAX preprocessors this module's tests build, kept by class, so
    that the OpenCV-free cases below reuse one and its compiled network (at
    the same input shapes) instead of compiling anew."""
    made = {}
    with pytest.MonkeyPatch.context() as mp:
        for cls in (jax_control.HEDPreprocessor, jax_pose.OpenposeBodyPreprocessor):
            def keep(self, *args, _init=cls.__init__, _cls=cls, **kwargs):
                _init(self, *args, **kwargs)
                made[_cls] = self

            mp.setattr(cls, "__init__", keep)
        yield made


@pytest.mark.parametrize("hw", [(70, 90), (40, 50)])
def test_hed_preprocessor_matches_jax_without_opencv(hed, jax_preprocessors,
                                                     monkeypatch, hw):
    """``test_hed_preprocessor_matches_jax``'s comparison with OpenCV
    unimportable on the port's side: plain, safe and scribble, 70 x 90 to
    the 64 x 64 bucket (INTER_AREA) and back (INTER_LINEAR), and 40 x 50 up
    to it (INTER_LANCZOS4) and back. Within one uint8 level (the networks'
    fp32 difference); the scribble map, 0 or 255, exactly."""
    tree, sd = hed
    theirs = jax_preprocessors.get(jax_control.HEDPreprocessor) \
        or jax_control.HEDPreprocessor(params=tree, detect_resolution=64)
    assert theirs.detect_resolution == 64
    image = (np.random.default_rng(1).random(hw + (3,)) * 255).astype(np.uint8)
    wants = {}
    for mode in ((False, False), (True, False), (False, True)):
        theirs.safe, theirs.scribble = mode
        wants[mode] = theirs(image)
    monkeypatch.setitem(sys.modules, "cv2", None)
    ours = control.HEDPreprocessor(state=sd, detect_resolution=64, device="cpu")
    for (safe, scribble), want in wants.items():
        ours.safe, ours.scribble = safe, scribble
        got = ours(image)
        assert got.shape == want.shape == hw + (3,) and got.dtype == np.uint8
        bound = 0 if scribble else 1
        err = np.abs(got.astype(int) - want.astype(int)).max()
        assert err <= bound, (safe, scribble, err)
        if scribble:
            assert set(np.unique(got)) <= {0, 255} and got.any()


def test_openpose_preprocessor_matches_jax_without_opencv(body, jax_preprocessors,
                                                           monkeypatch):
    """``test_openpose_preprocessor_matches_jax``'s end-to-end comparison
    with OpenCV unimportable on the port's side: the skeleton bitwise, and
    the same peaks (each within 1e-3 of the JAX score: the JAX package's
    uint8 INTER_CUBIC is IPP's here, a level off on a few pixels)."""
    tree, sd = body
    theirs = jax_preprocessors.get(jax_pose.OpenposeBodyPreprocessor) \
        or jax_pose.OpenposeBodyPreprocessor(params=tree)
    image = (np.random.default_rng(3).random((96, 128, 3)) * 255).astype(np.uint8)
    want, (want_cand, _) = theirs(image), theirs.estimate(image)
    monkeypatch.setitem(sys.modules, "cv2", None)
    ours = pose.OpenposeBodyPreprocessor(state=sd, device="cpu")
    got, (cand, _) = ours(image), ours.estimate(image)
    assert got.shape == (96, 128, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert len(cand) == len(want_cand) > 0
    np.testing.assert_array_equal(cand[:, [0, 1, 3]], want_cand[:, [0, 1, 3]])
    np.testing.assert_allclose(cand[:, 2], want_cand[:, 2], atol=1e-3)
