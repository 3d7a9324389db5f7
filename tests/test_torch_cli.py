"""The port's entry points against the JAX package's: ``controller.py``
(``PowerPaint.infer``) and the ``serve/cli.py`` one-shot mode.

The controller is held to the JAX package's with stub pipelines on each
side (the ControlNet route too), so the test sees exactly what each hands
its pipeline and what each makes of the same output; the command line's
parser is held to the JAX parser, and a tiny one-shot run goes through the
port on the CPU.
"""

import argparse
import os

import numpy as np
import pytest
import torch
from PIL import Image

from powerpaint_tpu import controller as jax_controller
from powerpaint_tpu.core import safety as jax_safety
from powerpaint_tpu.serve import cli as jax_cli
from powerpaint_tpu_torch import controller
from powerpaint_tpu_torch.core import safety
from powerpaint_tpu_torch.core.metrics import GLOBAL
from powerpaint_tpu_torch.serve import cli


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the ops here are tiny, and the suite's parallel
    workers would otherwise oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class StubPipeline:
    """Records what it is handed; returns a fixed image of the canvas's
    size."""

    def __init__(self):
        self.calls = []

    def __call__(self, image, mask, **kw):
        self.calls.append((np.array(image), np.array(mask), kw))
        h, w = image.shape[:2]
        out = (np.arange(h * w * 3).reshape(1, h, w, 3) * 7) % 251
        return out.astype(np.uint8)


def _request():
    rng = np.random.RandomState(0)
    image = (rng.rand(700, 530, 3) * 255).astype(np.uint8)
    mask = np.zeros((700, 530), np.float32)
    mask[200:450, 100:300] = 1.0
    return image, mask


CASES = [dict(task="text-guided", prompt="a dog"),
         dict(task="object-removal", negative_prompt="blurry", seed=3),
         dict(task="shape-guided", prompt="a vase", fitting_degree=0.4,
              strength=0.7),
         dict(task="image-outpainting", horizontal_expansion_ratio=1.5,
              vertical_expansion_ratio=1.2),
         dict(task="text-guided", prompt="a cat", resolution_bucketing=True,
              short_side=500)]


@pytest.fixture
def numpy_blend(monkeypatch):
    """The JAX package blends in its C++ native where it is built (one
    uint8 level of rounding apart); the port has only the numpy blend it
    falls back to (the natives are ROADMAP A10's remainder)."""
    from powerpaint_tpu.tasks import native

    monkeypatch.setattr(native, "native_available", lambda: False)


def _infer(module, pipeline, kw):
    image, mask = _request()
    res = module.PowerPaint(pipeline).infer(image, mask, num_inference_steps=3,
                                            **kw)
    return res, pipeline.calls[-1]


@pytest.mark.parametrize("kw", CASES, ids=lambda kw: kw["task"] + (
    "+bucketing" if kw.get("resolution_bucketing") else ""))
def test_controller_matches_jax(kw, numpy_blend):
    got, (img, msk, args) = _infer(controller, StubPipeline(), kw)
    want, (jimg, jmsk, jargs) = _infer(jax_controller, StubPipeline(), kw)
    np.testing.assert_array_equal(img, jimg)
    np.testing.assert_array_equal(msk, jmsk)
    assert args == jargs
    for name in ("result", "raw", "mask_overlay"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert got.nsfw_flags == want.nsfw_flags == [False]


def test_controller_safety_hook_matches_jax(numpy_blend):
    flag_all = lambda images: [True] * len(images)  # noqa: E731
    safety.register_safety_checker(flag_all)
    jax_safety.register_safety_checker(flag_all)
    try:
        assert safety.get_safety_checker() is flag_all
        got, _ = _infer(controller, StubPipeline(), CASES[0])
        want, _ = _infer(jax_controller, StubPipeline(), CASES[0])
    finally:
        safety.register_safety_checker(None)
        jax_safety.register_safety_checker(None)
    assert got.nsfw_flags == want.nsfw_flags == [True]
    assert not got.raw.any()
    np.testing.assert_array_equal(got.result, want.result)


@pytest.mark.parametrize("given", [False, True],
                         ids=["canny-from-cv2", "control_image"])
def test_controller_control_route_matches_jax(given, numpy_blend):
    """``control_type`` routes to the ControlNet pipeline with the control
    image given, or canny of the preprocessed image; the v1 pipeline is
    not called."""
    image, mask = _request()
    extra = {}
    if given:
        extra["control_image"] = (np.indices((696, 528)).sum(0) % 7 == 0)[
            ..., None].repeat(3, -1).astype(np.uint8) * 255
    results = []
    for module in (controller, jax_controller):
        plain, cn = StubPipeline(), StubPipeline()
        res = module.PowerPaint(plain, controlnet_pipeline=cn).infer(
            image, mask, control_type="canny", prompt="a vase",
            controlnet_conditioning_scale=0.7, num_inference_steps=3,
            guess_mode=True, **extra)
        assert plain.calls == [] and len(cn.calls) == 1
        results.append((res, cn.calls[0]))
    (got, (img, msk, kw)), (want, (jimg, jmsk, jkw)) = results
    np.testing.assert_array_equal(img, jimg)
    np.testing.assert_array_equal(msk, jmsk)
    ctrl, jctrl = kw.pop("control_image"), jkw.pop("control_image")
    assert ctrl.shape == img.shape and ctrl.dtype == np.uint8 and ctrl.any()
    np.testing.assert_array_equal(ctrl, jctrl)
    assert kw == jkw and kw["controlnet_conditioning_scale"] == 0.7
    for name in ("result", "raw", "mask_overlay"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


def test_controller_without_a_controlnet_pipeline_raises_as_jax():
    image, mask = _request()
    errors = []
    for module in (controller, jax_controller):
        with pytest.raises(ValueError) as exc:
            module.PowerPaint(StubPipeline()).infer(image, mask,
                                                    control_type="canny")
        errors.append(str(exc.value))
    assert errors[0] == errors[1]


def test_controller_refuses_what_is_not_ported():
    image, mask = _request()
    pp = controller.PowerPaint(StubPipeline())
    with pytest.raises(ValueError, match="ControlNet"):
        pp.infer(image, mask, control_type="canny")
    with pytest.raises(ValueError, match="requires a mask"):
        pp.infer(image, None)
    with pytest.raises(NotImplementedError, match="A14"):
        controller.PowerPaint.from_checkpoint("/nonexistent")


def _options(parser):
    return {a.dest: a for a in parser._actions
            if not isinstance(a, argparse._HelpAction)}


def test_parser_matches_jax():
    port, jax_opts = _options(cli.build_parser()), _options(jax_cli.build_parser())
    assert set(port) == set(jax_opts) | {"device"}
    for dest, want in jax_opts.items():
        got = port[dest]
        for field in ("option_strings", "default", "choices", "type", "nargs",
                      "const", "required", "metavar"):
            assert getattr(got, field) == getattr(want, field), (dest, field)
        assert type(got) is type(want), dest
    assert port["device"].default == "cuda"


@pytest.mark.parametrize("argv,item", [
    (["--checkpoint_dir", "ckpt"], "A14"), (["--lora", "x.safetensors"], "A14"),
    (["--textual_inversion", "t.bin"], "A14"), (["--serve"], "A17"),
    (["--micro-batch", "8"], "A17"), (["--aot-cache", "c.aot"], "A17"),
    (["--control_type", "canny"], "A12"), (["--scheduler", "pndm"], "A13"),
    (["--version", "ppt-v2", "--scheduler", "ddim"], "A13")])
def test_unported_options_are_refused(argv, item, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(argv + ["--image", "unused.png"])
    assert exc.value.code == 2
    assert f"ROADMAP {item}" in capsys.readouterr().err


def test_ported_scheduler_and_defaults_are_accepted():
    parser = cli.build_parser()
    defaults = parser.parse_args([])
    for argv in ([], ["--scheduler", "ddim"], ["--micro-batch", "4"],
                 ["--version", "ppt-v2", "--scheduler", "unipc"]):
        assert cli.unported(parser.parse_args(argv), defaults) == []


@pytest.mark.parametrize("version,int8", [("ppt-v1", "1"), ("ppt-v2", "0")])
def test_one_shot_tiny_on_the_cpu(tmp_path, capsys, monkeypatch, version, int8):
    """``--tiny --device cpu``: the random-weight demo stack on the CPU
    through the same preprocessing, blend and output line as the JAX
    command; ppt-v1 with POWERPAINT_INT8=1 (read by the pipeline)."""
    monkeypatch.setenv("POWERPAINT_INT8", int8)
    rng = np.random.RandomState(1)
    Image.fromarray((rng.rand(80, 72, 3) * 255).astype(np.uint8)).save(
        tmp_path / "in.png")
    m = np.zeros((80, 72), np.uint8)
    m[20:60, 16:50] = 255
    Image.fromarray(m).save(tmp_path / "mask.png")
    out = tmp_path / "out.png"
    argv = ["--tiny", "--device", "cpu", "--version", version,
            "--image", str(tmp_path / "in.png"), "--mask", str(tmp_path / "mask.png"),
            "--output", str(out), "--steps", "2", "--short_side", "64",
            "--prompt", "a dog", "--weight_dtype", "float32"]
    if version == "ppt-v2":
        argv += ["--profile", str(tmp_path / "trace")]
    assert cli.main(argv) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"wrote {out} (64x64) in ") and line.endswith("(2 steps)")
    with Image.open(out) as im:
        assert im.size == (64, 64) and im.mode == "RGB"
    assert GLOBAL.last_call_report().keys() == {"generate"}
    if version == "ppt-v2":
        assert os.path.exists(tmp_path / "trace" / "trace.json")
