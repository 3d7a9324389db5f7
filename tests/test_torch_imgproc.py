"""The port's OpenCV functions (``tasks/imgproc.py``, ``tasks/drawing.py``)
against ``cv2`` and against the JAX package's control-map functions, which
call ``cv2``: canny, the four resizes on uint8 and fp32, the Gaussian blur,
the dilation, the scribble pass's non-maximum suppression, ``addWeighted``
and the skeleton's rasterisers. Every input is made from a seed with numpy.

uint8 results are held bit for bit; fp32 results within 1e-6 of the
reference's largest magnitude. Where OpenCV hands a resize to Intel IPP
(uint8 INTER_CUBIC, single-channel fp32 INTER_LINEAR / INTER_CUBIC), the
reference is ``cv2`` with IPP off, OpenCV's own code, which the port
follows; IPP's uint8 INTER_CUBIC stays within one level of it.
"""

import cv2
import numpy as np
import pytest
import torch

from powerpaint_tpu.tasks import control as jax_control
from powerpaint_tpu.tasks import pose as jax_pose
from powerpaint_tpu_torch.tasks import control, drawing, imgproc, pose

CV_INTER = {imgproc.INTER_LINEAR: cv2.INTER_LINEAR,
            imgproc.INTER_CUBIC: cv2.INTER_CUBIC,
            imgproc.INTER_AREA: cv2.INTER_AREA,
            imgproc.INTER_LANCZOS4: cv2.INTER_LANCZOS4}
MODES = {"area": imgproc.INTER_AREA, "linear": imgproc.INTER_LINEAR,
         "cubic": imgproc.INTER_CUBIC, "lanczos4": imgproc.INTER_LANCZOS4}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are tiny, and torch's idle
    threads otherwise spin against OpenCV's own pool (alone, this file took
    about 100 s with torch's default threads against about 10 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def opencv_without_ipp():
    """cv2 with IPP off for the duration of a test: OpenCV's own code."""
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(True)


def _same(got, want):
    want = want.reshape(got.shape) if want.size == got.size else want
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape)
    if got.dtype == np.uint8:
        bad = int((got != want).sum())
        assert bad == 0, f"{bad} of {got.size} pixels differ"
    else:
        err = float(np.abs(got - want).max())
        assert err <= 1e-6 * float(np.abs(want).max()), err


# ------------------------------------------------------------------ canny


def _canny_images():
    rng = np.random.default_rng(0)
    shapes = [(5, 7), (7, 5), (9, 13), (16, 16), (31, 45), (64, 48), (77, 101),
              (120, 90), (33, 200)]
    for i, (h, w) in enumerate(shapes):
        yy, xx = np.mgrid[:h, :w]
        yield f"noise{h}x{w}", (rng.random((h, w, 3)) * 255).astype(np.uint8)
        yield f"smooth{h}x{w}", np.stack(
            [127 + 120 * np.sin(xx / (2.5 + c + i) + yy / (4 + c)) for c in range(3)],
            -1).astype(np.uint8)
    flat = np.full((40, 56, 3), 77, np.uint8)
    yield "flat", flat
    step = flat.copy()
    step[10:30, 20:] = (200, 30, 90)
    yield "flat_regions", step
    shapes_img = np.clip(rng.normal(128, 25, (96, 80, 3)), 0, 255).astype(np.uint8)
    cv2.circle(shapes_img, (40, 50), 25, (250, 10, 100), -1)
    cv2.rectangle(shapes_img, (5, 5), (30, 40), (20, 220, 60), -1)
    cv2.line(shapes_img, (0, 95), (79, 0), (255, 255, 255), 3)
    yield "drawn", shapes_img
    yy, xx = np.mgrid[:576, :512]
    big = np.stack([127 + 120 * np.sin(xx / 9 + yy / 13 + c) for c in range(3)], -1)
    big = np.clip(big + rng.normal(0, 12, big.shape), 0, 255).astype(np.uint8)
    yield "big576x512", big


CANNY_IMAGES = dict(_canny_images())


@pytest.mark.parametrize("name", sorted(CANNY_IMAGES))
def test_canny_is_the_jax_packages(name):
    image = CANNY_IMAGES[name]
    for low, high in ((100, 200), (50, 100)):
        want = jax_control.canny(image, low, high)
        got = control.canny(image, low, high)
        np.testing.assert_array_equal(got, want)
    assert len(CANNY_IMAGES) >= 20


def test_canny_of_one_channel_and_swapped_thresholds_is_opencvs():
    image = CANNY_IMAGES["drawn"][:, :, 1].copy()
    np.testing.assert_array_equal(imgproc.canny(image, 100, 200),
                                  cv2.Canny(image, 100, 200))
    np.testing.assert_array_equal(imgproc.canny(image, 200, 100),
                                  cv2.Canny(image, 200, 100))
    assert imgproc.canny(CANNY_IMAGES["drawn"], 100, 200).any()


# ------------------------------------------------------------------ resize


def _image(kind, h, w, c, seed):
    rng = np.random.default_rng(seed)
    if kind == "u8":
        x = (rng.random((h, w, c)) * 255).astype(np.uint8)
    else:
        x = rng.standard_normal((h, w, c)).astype(np.float32)
    return x[:, :, 0] if c == 1 else x


# (input h, w), then dsize (w, h) or fx, fy: down, up, mixed, by factors
GEOMETRY = [((70, 90), (64, 64)), ((64, 64), (90, 70)), ((37, 53), (101, 77)),
            ((100, 61), (33, 250)), ((5, 7), (3, 11)), ((96, 128), 0.37),
            ((41, 33), 1.7), ((60, 44), 0.5), ((45, 63), 1 / 3), ((23, 16), 8.0)]


# OpenCV's INTER_AREA takes at most 4 channels
RESIZE_CASES = [(mode, kind, c) for mode in sorted(MODES)
                for kind, c in (("u8", 1), ("u8", 3), ("f32", 1), ("f32", 3),
                                ("f32", 19))
                if not (mode == "area" and c > 4)]


@pytest.mark.parametrize("mode,kind,channels", RESIZE_CASES)
def test_resize_is_opencvs(mode, kind, channels, opencv_without_ipp):
    for i, ((h, w), size) in enumerate(GEOMETRY):
        x = _image(kind, h, w, channels, i)
        if isinstance(size, tuple):
            want = cv2.resize(x, size, interpolation=CV_INTER[MODES[mode]])
            got = imgproc.resize(x, size, interpolation=MODES[mode])
        else:
            want = cv2.resize(x, (0, 0), fx=size, fy=size,
                              interpolation=CV_INTER[MODES[mode]])
            got = imgproc.resize(x, fx=size, fy=size, interpolation=MODES[mode])
        _same(got, want)


@pytest.mark.parametrize("hw,size,mode", [
    ((70, 90, 3), (64, 64), "area"), ((40, 50, 3), (64, 64), "lanczos4"),
    ((64, 64), (90, 70), "linear"), ((64, 64), (50, 40), "linear"),
    ((300, 517, 3), (1024, 576), "lanczos4"), ((777, 1000, 3), (640, 512), "area"),
    ((576, 1024), (517, 300), "linear"), ((1024, 1024), (512, 512), "linear")])
def test_hed_resizes_are_opencvs_with_ipp_on(hw, size, mode):
    """HED's shapes (in: INTER_AREA down or INTER_LANCZOS4 up to the
    bucket; out: INTER_LINEAR), against cv2 as the JAX package calls it."""
    x = _image("u8", hw[0], hw[1], hw[2] if len(hw) == 3 else 1, 7)
    _same(imgproc.resize(x, size, interpolation=MODES[mode]),
          cv2.resize(x, size, interpolation=CV_INTER[MODES[mode]]))


@pytest.mark.parametrize("hw", [(96, 128), (512, 512), (301, 517), (640, 427)])
def test_pose_resizes_are_opencvs(hw, opencv_without_ipp):
    """The pose network input (uint8 INTER_CUBIC by fx = fy = 184 / h)
    bitwise, and the fields' two INTER_CUBIC upsamples (38 and 19
    channels, which IPP does not take) with IPP off and on."""
    x = _image("u8", hw[0], hw[1], 3, 8)
    s = 0.5 * pose.BOXSIZE / hw[0]
    got = imgproc.resize(x, fx=s, fy=s, interpolation=imgproc.INTER_CUBIC)
    _same(got, cv2.resize(x, (0, 0), fx=s, fy=s, interpolation=cv2.INTER_CUBIC))
    (h, w), (hp, wp) = pose.network_shape(*hw)
    assert got.shape[:2] == (h, w)
    for c in (38, 19):
        field = _image("f32", hp // 8, wp // 8, c, c)
        up = imgproc.resize(field, fx=8, fy=8, interpolation=imgproc.INTER_CUBIC)
        _same(up, cv2.resize(field, (0, 0), fx=8, fy=8, interpolation=cv2.INTER_CUBIC))
        up = np.ascontiguousarray(up[:h, :w])
        for ipp in (False, True):
            cv2.ipp.setUseIPP(ipp)
            _same(imgproc.resize(up, hw[::-1], interpolation=imgproc.INTER_CUBIC),
                  cv2.resize(up, hw[::-1], interpolation=cv2.INTER_CUBIC))


def test_ipp_cubic_stays_within_a_level():
    """With IPP on (the JAX package's cv2 here), uint8 INTER_CUBIC is
    IPP's, which the port does not reproduce: within one level of it."""
    x = _image("u8", 96, 128, 3, 9)
    s = 0.5 * pose.BOXSIZE / 96
    got = imgproc.resize(x, fx=s, fy=s, interpolation=imgproc.INTER_CUBIC)
    want = cv2.resize(x, (0, 0), fx=s, fy=s, interpolation=cv2.INTER_CUBIC)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("case", ["same_size", "linear_by_2", "area_by_2_odd",
                                  "area_by_3", "area_up", "area_mixed", "one_pixel"])
def test_resize_special_cases_are_opencvs(case, opencv_without_ipp):
    """OpenCV's branches: the same size is a copy, INTER_LINEAR by exactly
    2 is INTER_AREA's block mean, integer INTER_AREA with blocks cut by the
    edge, INTER_AREA upwards (its linear emulation), down on one axis and
    up on the other, and a one-pixel side."""
    args = {"same_size": ((33, 47), dict(dsize=(47, 33)), imgproc.INTER_CUBIC),
            "linear_by_2": ((64, 90), dict(dsize=(45, 32)), imgproc.INTER_LINEAR),
            "area_by_2_odd": ((63, 91), dict(fx=0.5, fy=0.5), imgproc.INTER_AREA),
            "area_by_3": ((60, 90), dict(dsize=(30, 20)), imgproc.INTER_AREA),
            "area_up": ((20, 30), dict(dsize=(77, 41)), imgproc.INTER_AREA),
            "area_mixed": ((80, 20), dict(dsize=(50, 33)), imgproc.INTER_AREA),
            "one_pixel": ((1, 40), dict(dsize=(17, 9)), imgproc.INTER_LINEAR)}[case]
    (h, w), kw, mode = args
    for kind in ("u8", "f32"):
        for c in (1, 3):
            x = _image(kind, h, w, c, c)
            if "dsize" in kw:
                want = cv2.resize(x, kw["dsize"], interpolation=CV_INTER[mode])
            else:
                want = cv2.resize(x, (0, 0), fx=kw["fx"], fy=kw["fy"],
                                  interpolation=CV_INTER[mode])
            _same(imgproc.resize(x, interpolation=mode, **kw), want)


def test_resize_keeps_the_callers_kind():
    x = _image("u8", 30, 40, 3, 0)
    out = imgproc.resize(torch.from_numpy(x), (20, 10),
                         interpolation=imgproc.INTER_AREA)
    assert isinstance(out, torch.Tensor) and out.shape == (10, 20, 3)
    np.testing.assert_array_equal(
        out.numpy(), imgproc.resize(x, (20, 10), interpolation=imgproc.INTER_AREA))
    with pytest.raises(ValueError, match="uint8 or float32"):
        imgproc.resize(x.astype(np.int16), (20, 10))


# ------------------------------------------------------------------ blur, dilate


@pytest.mark.parametrize("kind", ["u8", "f32"])
@pytest.mark.parametrize("sigma", [3.0, 0.7, 1.0, 1.4, 2.3, 5.0])
def test_gaussian_blur_is_opencvs(kind, sigma):
    """Bit for bit on uint8, and on fp32 too at these kernels (7 taps and
    more: OpenCV's row tails fuse the taps past a multiple of 4); at sizes
    from one pixel wide up, where the kernel is wider than the image and
    BORDER_REFLECT_101 reflects again."""
    for i, (h, w, c) in enumerate([(1, 19, 1), (19, 1, 1), (7, 5, 1), (40, 77, 1),
                                   (64, 64, 3), (33, 90, 1), (90, 33, 3)]):
        x = _image(kind, h, w, c, i)
        if kind == "f32" and i % 2:
            x = np.round(np.abs(x) * 60).astype(np.float32)  # a uint8 map as fp32
        got, want = imgproc.gaussian_blur(x, sigma), cv2.GaussianBlur(x, (0, 0), sigma)
        np.testing.assert_array_equal(got.reshape(want.shape), want)


def test_dilate_is_opencvs():
    rng = np.random.default_rng(3)
    for i in range(12):
        h, w = (int(v) for v in rng.integers(1, 40, 2))
        x = _image("u8" if i % 2 else "f32", h, w, 1, i)
        kernel = (rng.random((3, 3)) > 0.5).astype(np.uint8)
        kernel[0, 0] |= not kernel.any()
        np.testing.assert_array_equal(imgproc.dilate(x, kernel), cv2.dilate(x, kernel))
    for kernel in control._LINE_KERNELS:
        x = _image("f32", 30, 41, 1, 5)
        np.testing.assert_array_equal(imgproc.dilate(x, kernel), cv2.dilate(x, kernel))


def _edge_maps():
    """uint8 edge maps as HED's scribble pass sees them: smooth ridges,
    thin lines, saturated plateaus, noise."""
    rng = np.random.default_rng(4)
    for h, w in ((70, 90), (64, 64), (41, 97), (128, 96)):
        yy, xx = np.mgrid[:h, :w]
        ridge = 255 * np.exp(-((np.sin(xx / 7.0) * 9 + yy - h / 2) ** 2) / 30.0)
        m = ridge + rng.normal(0, 20, (h, w))
        m[h // 4:h // 2, w // 5:w // 2] = 255  # a plateau
        m = np.clip(m, 0, 255).astype(np.uint8)
        cv2.line(m, (0, h - 1), (w - 1, h // 3), 200, 2)
        yield m
    yield (rng.random((50, 60)) * 255).astype(np.uint8)


@pytest.mark.parametrize("i", range(5))
def test_nms_edges_is_the_jax_packages(i):
    x = list(_edge_maps())[i]
    want = jax_control.nms_edges(x, 127, 3.0)
    got = control.nms_edges(x, 127, 3.0)
    np.testing.assert_array_equal(got, want)
    assert got.any()
    t = control.nms_edges(torch.from_numpy(x), 127, 3.0)
    np.testing.assert_array_equal(t.numpy(), want)


# ------------------------------------------------------------------ drawing


def test_ellipse2poly_is_opencvs():
    rng = np.random.default_rng(5)
    for _ in range(400):
        c = (int(rng.integers(-20, 120)), int(rng.integers(-20, 120)))
        axes = (int(rng.integers(0, 90)), int(rng.integers(0, 12)))
        angle = int(rng.integers(-400, 800))
        a0, a1 = (int(v) for v in rng.integers(-400, 800, 2))
        delta = int(rng.integers(1, 40))
        np.testing.assert_array_equal(
            drawing.ellipse2poly(c, axes, angle, a0, a1, delta),
            cv2.ellipse2Poly(c, axes, angle, a0, a1, delta))
    with pytest.raises(ValueError, match="delta"):
        drawing.ellipse2poly((0, 0), (3, 3), 0, 0, 360, 0)


def test_lines_polygons_and_discs_leaving_the_canvas_are_opencvs():
    rng = np.random.default_rng(6)
    for _ in range(200):
        h, w = (int(v) for v in rng.integers(5, 70, 2))
        col = tuple(int(v) for v in rng.integers(1, 256, 3))
        a = (int(rng.integers(-40, w + 40)), int(rng.integers(-40, h + 40)))
        b = (int(rng.integers(-40, w + 40)), int(rng.integers(-40, h + 40)))
        pts = np.stack([rng.integers(-30, w + 30, 5), rng.integers(-30, h + 30, 5)],
                       1).astype(np.int32)
        hull = cv2.convexHull(pts)[:, 0]
        ellipse = cv2.ellipse2Poly(a, (int(rng.integers(0, 60)), 4),
                                   int(rng.integers(-180, 180)), 0, 360, 1)
        r = int(rng.integers(0, 25))
        for ours, theirs in (
                (lambda m: drawing.line(m, a, b, col),
                 lambda m: cv2.line(m, a, b, col, 1)),
                (lambda m: drawing.fill_convex_poly(m, hull, col),
                 lambda m: cv2.fillConvexPoly(m, hull, col)),
                (lambda m: drawing.fill_convex_poly(m, ellipse, col),
                 lambda m: cv2.fillConvexPoly(m, ellipse, col)),
                (lambda m: drawing.circle(m, a, r, col),
                 lambda m: cv2.circle(m, a, r, col, -1))):
            got, want = np.zeros((h, w, 3), np.uint8), np.zeros((h, w, 3), np.uint8)
            ours(got)
            theirs(want)
            np.testing.assert_array_equal(got, want)


def test_add_weighted_is_opencvs():
    rng = np.random.default_rng(7)
    for alpha, beta, gamma in ((0.4, 0.6, 0.0), (0.3, 0.5, 10.0), (0.5, 0.5, 0.0)):
        a = (rng.random((37, 53, 3)) * 255).astype(np.uint8)
        b = (rng.random((37, 53, 3)) * 255).astype(np.uint8)
        np.testing.assert_array_equal(imgproc.add_weighted(a, alpha, b, beta, gamma),
                                      cv2.addWeighted(a, alpha, b, beta, gamma))


def _skeleton(rng, h, w, people):
    """(candidate, subset): ``people`` rows of 18 parts, some missing, the
    points spread past the canvas so that limbs run off it."""
    candidate, subset = [], []
    for _ in range(people):
        row = -np.ones(20)
        for part in range(18):
            if rng.random() < 0.85:
                x = rng.uniform(-0.2 * w, 1.2 * w)
                y = rng.uniform(-0.2 * h, 1.2 * h)
                row[part] = len(candidate)
                candidate.append((x, y, rng.random(), len(candidate)))
        row[18], row[19] = 10.0, float((row[:18] >= 0).sum())
        subset.append(row)
    return np.array(candidate, np.float64).reshape(-1, 4), np.array(subset)


@pytest.mark.parametrize("seed", range(4))
def test_draw_bodypose_is_the_jax_packages(seed):
    rng = np.random.default_rng(seed)
    h, w = [(96, 128), (64, 64), (120, 80), (50, 150)][seed]
    candidate, subset = _skeleton(rng, h, w, people=1 + seed)
    want = jax_pose.draw_bodypose(h, w, candidate, subset)
    got = pose.draw_bodypose(h, w, candidate, subset)
    np.testing.assert_array_equal(got, want)
    assert got.any()
