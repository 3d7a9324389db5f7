"""The port's entry points against the JAX package's: ``controller.py``
(``PowerPaint.infer``) and the ``serve/cli.py`` one-shot mode.

The controller is held to the JAX package's with stub pipelines on each
side (the ControlNet route too), so the test sees exactly what each hands
its pipeline and what each makes of the same output; the command line's
parser is held to the JAX parser, and a tiny one-shot run goes through the
port on the CPU. The samplers' call surface: ``scheduler=`` reaches the
pipeline through the controller and the command line, each registry name
runs on each of the three tiny pipelines, and a bad name or LCM past its
grid is an ``InputValidationError`` before any device work.
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


def _infer(module, pipeline, kw):
    image, mask = _request()
    res = module.PowerPaint(pipeline).infer(image, mask, num_inference_steps=3,
                                            **kw)
    return res, pipeline.calls[-1]


@pytest.mark.parametrize("kw", CASES, ids=lambda kw: kw["task"] + (
    "+bucketing" if kw.get("resolution_bucketing") else ""))
def test_controller_matches_jax(kw):
    got, (img, msk, args) = _infer(controller, StubPipeline(), kw)
    want, (jimg, jmsk, jargs) = _infer(jax_controller, StubPipeline(), kw)
    np.testing.assert_array_equal(img, jimg)
    np.testing.assert_array_equal(msk, jmsk)
    assert args == jargs
    for name in ("result", "raw", "mask_overlay"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert got.nsfw_flags == want.nsfw_flags == [False]


def test_controller_safety_hook_matches_jax():
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
def test_controller_control_route_matches_jax(given):
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
    """What a call cannot do is refused; ``from_checkpoint`` loads (ROADMAP
    A14a), so a directory without weights is the JAX package's
    ``FileNotFoundError``."""
    image, mask = _request()
    pp = controller.PowerPaint(StubPipeline())
    with pytest.raises(ValueError, match="ControlNet"):
        pp.infer(image, mask, control_type="canny")
    with pytest.raises(ValueError, match="requires a mask"):
        pp.infer(image, None)
    errors = []
    for module in (controller, jax_controller):
        with pytest.raises(FileNotFoundError) as exc:
            module.PowerPaint.from_checkpoint("/nonexistent")
        errors.append(str(exc.value))
    assert errors[0] == errors[1]


def _write_tiny_checkpoint(root, lora_path, ti_path):
    """A tiny ppt-v1 directory in the reference layout, a kohya LoRA over
    two UNet projections and a ResNet conv, and a 2-vector A1111
    textual-inversion file."""
    from powerpaint_tpu_torch.io.safetensors import save_file
    from powerpaint_tpu_torch.io.weights import init_state
    from powerpaint_tpu_torch.testing import tiny_v1_config

    state = init_state(tiny_v1_config(), torch.Generator().manual_seed(0),
                       device="cpu")
    for family, name in (("unet", "diffusion_pytorch_model"),
                         ("text_encoder", "model"),
                         ("vae", "diffusion_pytorch_model")):
        os.makedirs(root / family)
        save_file(state[family], str(root / family / f"{name}.safetensors"))
    g = torch.Generator().manual_seed(1)
    lora = {}
    for module in ("down_blocks.1.attentions.0.transformer_blocks.0.attn1.to_q",
                   "down_blocks.1.attentions.0.transformer_blocks.0.ff.net.2",
                   "up_blocks.2.resnets.1.conv1"):
        w = state["unet"][module + ".weight"]
        name = "lora_unet_" + module.replace(".", "_")
        lora[name + ".lora_down.weight"] = torch.randn(4, *w.shape[1:],
                                                       generator=g) * 0.1
        lora[name + ".lora_up.weight"] = torch.randn(
            w.shape[0], 4, *([1, 1] if w.ndim == 4 else []), generator=g) * 0.1
        lora[name + ".alpha"] = torch.tensor(2.0)
    save_file(lora, str(lora_path))
    torch.save({"<cat-toy>": torch.randn(2, 32, generator=g)}, ti_path)


@pytest.mark.parametrize("flag", ["--checkpoint_dir", "--lora",
                                  "--textual_inversion"])
def test_a14_options_load(tmp_path, capsys, flag):
    """The three options ROADMAP A14a ported: ``--checkpoint_dir`` as a
    tiny one-shot run on the CPU with all three, which writes the PNG;
    ``--lora PATH:SCALE`` merges into the demo stack at that scale;
    ``--textual_inversion PATH`` registers the file's token."""
    from powerpaint_tpu_torch.io import lora

    ckpt, lora_path, ti = (tmp_path / "ppt-v1", tmp_path / "style.safetensors",
                           tmp_path / "cat-toy.pt")
    _write_tiny_checkpoint(ckpt, lora_path, ti)
    parser = cli.build_parser()
    base = ["--tiny", "--device", "cpu", "--weight_dtype", "float32"]
    if flag == "--checkpoint_dir":
        rng = np.random.RandomState(1)
        Image.fromarray((rng.rand(64, 64, 3) * 255).astype(np.uint8)).save(
            tmp_path / "in.png")
        m = np.zeros((64, 64), np.uint8)
        m[16:48, 16:48] = 255
        Image.fromarray(m).save(tmp_path / "mask.png")
        out = tmp_path / "out.png"
        argv = base + ["--checkpoint_dir", str(ckpt), "--lora", f"{lora_path}:0.5",
                       "--textual_inversion", str(ti),
                       "--image", str(tmp_path / "in.png"),
                       "--mask", str(tmp_path / "mask.png"), "--output", str(out),
                       "--steps", "2", "--short_side", "64",
                       "--prompt", "a <cat-toy> on a bench"]
        assert cli.control_problems(parser.parse_args(argv)) == []
        assert cli.main(argv) == 0
        lines = capsys.readouterr().out.strip().splitlines()
        assert lines[0] == f"lora: merged {lora_path} (scale 0.5)"
        assert lines[1] == f"textual inversion: registered {ti}"
        assert lines[-1].startswith(f"wrote {out} (64x64) in ")
        with Image.open(out) as im:
            assert im.size == (64, 64) and im.mode == "RGB"
        return
    if flag == "--lora":
        pipe = cli.build_pipeline(parser.parse_args(
            base + ["--lora", f"{lora_path}:0.5"]))
        want = cli.build_pipeline(parser.parse_args(base))
        assert want.load_lora_weights(str(lora_path), scale=0.5) == []
        for t in lora.TARGETS:
            theirs = getattr(want, t).state_dict()
            for k, v in getattr(pipe, t).state_dict().items():
                assert torch.equal(v, theirs[k]), k
        assert pipe._loaded_loras[-1][1] == 0.5
        return
    pipe = cli.build_pipeline(parser.parse_args(
        base + ["--version", "ppt-v2", "--textual_inversion", str(ti)]))
    assert pipe.tokenizer.token_map["<cat-toy>"] == ["<cat-toy>_0", "<cat-toy>_1"]
    table = pipe.text_encoder_brushnet.text_model.embeddings.token_embedding
    assert table.names[-1] == "<cat-toy>"
    assert torch.equal(table.trainable_embeddings["<cat-toy>"],
                       torch.load(ti)["<cat-toy>"])


def test_entry_points_run_on_the_card_unless_asked():
    """``device`` defaults to the card at every entry point; on a machine
    without one, a load that is not asked for the CPU fails, never falls
    back to it."""
    import inspect

    import powerpaint_tpu_torch
    from powerpaint_tpu_torch.io import checkpoint

    for fn in (checkpoint.load_ppt_v1, checkpoint.load_ppt_v2,
               checkpoint.load_single_file, checkpoint.load_safety_checker):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert cli.build_parser().parse_args([]).device == "cuda"
    assert callable(powerpaint_tpu_torch.load)


def _options(parser):
    return {a.dest: a for a in parser._actions
            if not isinstance(a, argparse._HelpAction)}


def test_parser_matches_jax():
    port, jax_opts = _options(cli.build_parser()), _options(jax_cli.build_parser())
    assert set(port) == set(jax_opts) | {"device", "controlnet_dir"}
    for dest, want in jax_opts.items():
        got = port[dest]
        for field in ("option_strings", "default", "choices", "type", "nargs",
                      "const", "required", "metavar"):
            assert getattr(got, field) == getattr(want, field), (dest, field)
        assert type(got) is type(want), dest
    assert port["device"].default == "cuda"


class _ServedStub(StubPipeline):
    """A pipeline for ``serve.app.launch``: records ``aot_load``."""

    loaded = None

    def aot_load(self, path):
        self.loaded = path
        return []


@pytest.mark.parametrize("argv,reaches", [
    (["--serve"], "launch"),
    (["--serve", "--micro-batch", "8"], "make_server"),
    (["--serve", "--aot-cache", "c.aot"], "aot_load")])
def test_unported_options_are_refused(argv, reaches, tmp_path, monkeypatch,
                                      capsys):
    """The serving options, refused while ROADMAP A17b was not ported, now
    reach their modules: ``--serve`` launches the HTTP server (no gradio
    here; ``serve_forever`` returns at once), with ``--micro-batch`` (4 by
    default) coalescing through its batcher, and ``--aot-cache`` loads an
    existing file before serving."""
    from powerpaint_tpu_torch.serve import app

    stub, served = _ServedStub(), []
    monkeypatch.setattr(cli, "build_pipeline", lambda args: stub)
    monkeypatch.setattr(app._Server, "serve_forever",
                        lambda self: served.append(self))
    monkeypatch.chdir(tmp_path)
    (tmp_path / "c.aot").write_bytes(b"")
    assert cli.main(argv + ["--port", "0"]) == 0
    server, = served
    out = capsys.readouterr().out
    assert "POST /inpaint" in out
    want_batch = 8 if reaches == "make_server" else 4
    assert server.batcher is not None and server.batcher.max_batch == want_batch
    assert not server.batcher._thread.is_alive()  # closed with the server
    if reaches == "aot_load":
        assert stub.loaded == "c.aot" and "aot: loaded c.aot" in out
    else:
        assert stub.loaded is None


def test_control_type_runs_a_controlnet_one_shot(tmp_path, capsys):
    """``--control_type canny --controlnet_dir DIR``: the tiny demo ppt-v1
    stack with the directory's ControlNet branch on the CPU, the canny map
    of the processed image (OpenCV here), the PNG and the output line with
    the control stage; the pipeline it builds is the ControlNet pipeline
    over the demo stack's models."""
    from powerpaint_tpu_torch.pipelines.controlnet import ControlNetPipeline
    from powerpaint_tpu_torch.testing import tiny_v1_controlnet_config
    from test_torch_checkpoint import controlnet_state, write_controlnet

    cn_dir = tmp_path / "controlnet"
    write_controlnet(cn_dir, controlnet_state(),
                     tiny_v1_controlnet_config().controlnet)
    rng = np.random.RandomState(1)
    Image.fromarray((rng.rand(80, 72, 3) * 255).astype(np.uint8)).save(
        tmp_path / "in.png")
    m = np.zeros((80, 72), np.uint8)
    m[20:60, 16:50] = 255
    Image.fromarray(m).save(tmp_path / "mask.png")
    out = tmp_path / "out.png"
    base = ["--tiny", "--device", "cpu", "--weight_dtype", "float32",
            "--control_type", "canny", "--controlnet_dir", str(cn_dir)]
    pipe = cli.build_pipeline(cli.build_parser().parse_args(base))
    assert isinstance(pipe, ControlNetPipeline) and len(pipe.controlnet) == 1
    argv = base + ["--image", str(tmp_path / "in.png"), "--mask",
                   str(tmp_path / "mask.png"), "--output", str(out), "--steps",
                   "2", "--short_side", "64", "--prompt", "a vase"]
    assert cli.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2].startswith("control: canny map (64x64) in ")
    assert lines[-1].startswith(f"wrote {out} (64x64) in ")
    assert lines[-1].endswith("(2 steps, control canny)")
    with Image.open(out) as im:
        assert im.size == (64, 64) and im.mode == "RGB"


@pytest.mark.parametrize("argv,message", [
    (["--version", "ppt-v2", "--control_type", "hed"], "needs --version ppt-v1"),
    (["--controlnet_dir", "cn"], "--controlnet_dir needs --control_type"),
    (["--control_type", "depth", "--checkpoint_dir", "ckpt"],
     "--checkpoint_dir needs --controlnet_dir")])
def test_control_options_are_checked(argv, message, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(argv + ["--image", "unused.png"])
    assert exc.value.code == 2
    assert message in capsys.readouterr().err


def test_ported_scheduler_and_defaults_are_accepted(monkeypatch):
    """Every option the command takes reaches the one-shot run, or with
    ``--serve`` the server's launch, as parsed."""
    from powerpaint_tpu_torch.serve import app

    reached = []
    monkeypatch.setattr(cli, "run_one_shot",
                        lambda args: reached.append(("one-shot", args)) or 0)
    monkeypatch.setattr(app, "launch",
                        lambda args: reached.append(("serve", args)) or 0)
    for argv in ([], ["--scheduler", "ddim"], ["--micro-batch", "4"],
                 ["--version", "ppt-v2", "--scheduler", "unipc"],
                 ["--scheduler", "pndm"],
                 ["--version", "ppt-v2", "--scheduler", "ddim"],
                 ["--serve"], ["--serve", "--micro-batch", "8", "--share"],
                 ["--aot-cache", "c.aot"],
                 ["--serve", "--aot-cache", "c.aot", "--port", "7861"]):
        reached.clear()
        assert cli.main(argv) == 0
        (mode, args), = reached
        assert mode == ("serve" if "--serve" in argv else "one-shot")
        assert vars(args) == vars(cli.build_parser().parse_args(argv))


def test_aot_cache_one_shot_loads_or_dumps(tmp_path, monkeypatch, capsys):
    """``--aot-cache FILE`` on the one-shot command: without the file the
    call builds as usual and dumps the built libraries after it; with it,
    they are installed before the call; a file that is refused is reported
    and the run goes on. ``_build/`` is a temporary copy holding the host
    natives the blend needs."""
    import shutil

    from powerpaint_tpu_torch.io import aot
    from powerpaint_tpu_torch.ops import _build

    _build.load_native("image")  # built where the suite builds it
    real = _build.native_library_path("image")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    _build.BUILD_DIR.mkdir()
    shutil.copy(real, _build.native_library_path("image"))
    rng = np.random.RandomState(1)
    Image.fromarray((rng.rand(64, 64, 3) * 255).astype(np.uint8)).save(
        tmp_path / "in.png")
    m = np.zeros((64, 64), np.uint8)
    m[16:48, 16:48] = 255
    Image.fromarray(m).save(tmp_path / "mask.png")
    cache = tmp_path / "kernels.aot"
    argv = ["--tiny", "--device", "cpu", "--weight_dtype", "float32",
            "--image", str(tmp_path / "in.png"), "--mask",
            str(tmp_path / "mask.png"), "--output", str(tmp_path / "out.png"),
            "--steps", "2", "--short_side", "64", "--aot-cache", str(cache)]

    assert cli.main(argv) == 0
    captured = capsys.readouterr()
    assert f"aot: dumped {cache}" in captured.out, captured.err
    header = aot.read_header(str(cache))
    assert header["device"] == "cpu" and header["mode"] == "int8=0"
    assert {lib["key"] for lib in header["libraries"]} >= {"native:image"}
    built = {p.name: p.read_bytes() for p in _build.BUILD_DIR.iterdir()}

    for p in _build.BUILD_DIR.iterdir():
        p.unlink()
    assert cli.main(argv) == 0
    assert f"aot: loaded {cache}" in capsys.readouterr().out
    assert {p.name: p.read_bytes() for p in _build.BUILD_DIR.iterdir()} == built

    cache.write_bytes(b"PPTAOTT1\n" + (0).to_bytes(8, "little"))
    assert cli.main(argv) == 0
    captured = capsys.readouterr()
    assert f"aot: ignoring {cache}: {cache}: corrupt cache header" in captured.err
    assert captured.out.strip().splitlines()[-1].startswith(
        f"wrote {tmp_path / 'out.png'} (64x64) in ")


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


def test_cli_scheduler_choices_are_the_registry():
    from powerpaint_tpu_torch import schedulers

    port = _options(cli.build_parser())["scheduler"]
    assert tuple(port.choices) == schedulers.SCHEDULERS


def test_controller_forwards_scheduler_as_jax():
    """``scheduler=`` is one of ``infer``'s pipeline keyword arguments, on
    the plain and on the ControlNet route, in both packages."""
    kw = dict(CASES[0], scheduler="euler")
    got, (_, _, args) = _infer(controller, StubPipeline(), kw)
    _, (_, _, jargs) = _infer(jax_controller, StubPipeline(), kw)
    assert args["scheduler"] == jargs["scheduler"] == "euler" and args == jargs
    image, mask = _request()
    cn = StubPipeline()
    controller.PowerPaint(StubPipeline(), controlnet_pipeline=cn).infer(
        image, mask, control_type="canny", control_image=np.zeros(
            (696, 528, 3), np.uint8), scheduler="heun", num_inference_steps=3)
    assert cn.calls[0][2]["scheduler"] == "heun"


@pytest.fixture(scope="module")
def tiny_pipelines():
    """The three tiny pipelines of the port, random weights, on the CPU."""
    from powerpaint_tpu_torch.io.weights import init_state
    from powerpaint_tpu_torch.pipelines.brushnet import BrushNetPipeline
    from powerpaint_tpu_torch.pipelines.controlnet import ControlNetPipeline
    from powerpaint_tpu_torch.pipelines.inpaint import InpaintPipeline
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

    tok = TokenizerWrapper(HashTokenizer(994))
    add_task_tokens(tok)
    out = {}
    for name, cls, cfg in (("v1", InpaintPipeline, tiny_v1_config()),
                           ("v2", BrushNetPipeline, tiny_v2_config()),
                           ("cn", ControlNetPipeline, tiny_v1_controlnet_config())):
        state = init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
        out[name] = cls(cfg, state, tok, dtype=torch.float32, device="cpu")
    return out


@pytest.mark.parametrize("pipeline", ["v1", "v2", "cn"])
@pytest.mark.parametrize("kw,match", [
    (dict(scheduler="karras"), "unknown scheduler"),
    (dict(scheduler="lcm", num_inference_steps=60), "original_inference_steps"),
    (dict(scheduler="LCM", num_inference_steps=51), "original_inference_steps")],
    ids=["unknown", "lcm-60", "lcm-51"])
def test_bad_sampler_raises_before_device_work(tiny_pipelines, monkeypatch,
                                               pipeline, kw, match):
    from powerpaint_tpu_torch.core.validation import InputValidationError

    pipe = tiny_pipelines[pipeline]
    monkeypatch.setattr(pipe, "_generate", None)  # any device work fails
    rng = np.random.RandomState(0)
    image = (rng.rand(64, 64, 3) * 255).astype(np.uint8)
    mask = np.zeros((64, 64), np.float32)
    mask[16:48, 16:48] = 1.0
    extra = ([np.zeros((64, 64, 3), np.uint8)] if pipeline == "cn" else [])
    kw = {"num_inference_steps": 4, **kw}
    with pytest.raises(InputValidationError, match=match):
        pipe(image, mask, *extra, prompt="x", **kw)


@pytest.mark.parametrize("argv,code", [
    (["--scheduler", "karras"], 2),
    (["--scheduler", "lcm", "--steps", "60"], None),
    (["--version", "ppt-v2", "--scheduler", "lcm", "--steps", "60"], None)],
    ids=["unknown", "lcm-60-v1", "lcm-60-v2"])
def test_cli_refuses_a_bad_sampler_before_building(argv, code, monkeypatch,
                                                   capsys):
    """An unknown name is the parser's error (exit 2); LCM past its grid is
    the pipelines' ``InputValidationError``, before the stack is built."""
    from powerpaint_tpu_torch.core.validation import InputValidationError

    monkeypatch.setattr(cli, "build_pipeline", None)
    if code is not None:
        with pytest.raises(SystemExit) as exc:
            cli.main(argv + ["--image", "unused.png"])
        assert exc.value.code == code and "karras" in capsys.readouterr().err
        return
    with pytest.raises(InputValidationError, match="original_inference_steps"):
        cli.main(argv + ["--image", "unused.png"])


def test_one_shot_passes_the_scheduler(tmp_path, monkeypatch):
    """``--scheduler`` reaches the ppt-v1 pipeline's call (it used to be
    ppt-v2's alone)."""
    from powerpaint_tpu_torch.pipelines.inpaint import InpaintPipeline

    seen = []
    call = InpaintPipeline.__call__
    monkeypatch.setattr(InpaintPipeline, "__call__",
                        lambda self, *a, **k: seen.append(k) or call(self, *a, **k))
    rng = np.random.RandomState(2)
    Image.fromarray((rng.rand(64, 64, 3) * 255).astype(np.uint8)).save(
        tmp_path / "in.png")
    m = np.zeros((64, 64), np.uint8)
    m[16:48, 16:48] = 255
    Image.fromarray(m).save(tmp_path / "mask.png")
    assert cli.main(["--tiny", "--device", "cpu", "--image", str(tmp_path / "in.png"),
                     "--mask", str(tmp_path / "mask.png"), "--steps", "2",
                     "--short_side", "64", "--weight_dtype", "float32",
                     "--scheduler", "euler_a",
                     "--output", str(tmp_path / "out.png")]) == 0
    assert seen[0]["scheduler"] == "euler_a"


@pytest.mark.parametrize("pipeline", ["v1", "v2", "cn"])
@pytest.mark.parametrize("name", ["ddim", "pndm", "unipc", "dpm", "euler",
                                  "euler_a", "heun", "lms", "deis", "dpm_sde",
                                  "lcm"])
def test_every_sampler_runs_on_every_pipeline(tiny_pipelines, pipeline, name):
    """``scheduler=`` takes each registry name on the three pipelines: a
    finite image, and the same one again from the same seed."""
    pipe = tiny_pipelines[pipeline]
    rng = np.random.RandomState(0)
    image = (rng.rand(32, 32, 3) * 255).astype(np.uint8)
    mask = np.zeros((32, 32), np.float32)
    mask[8:24, 8:24] = 1.0
    extra = [np.zeros((32, 32, 3), np.uint8)] if pipeline == "cn" else []
    kw = dict(prompt="x", num_inference_steps=2, scheduler=name, seed=3,
              output_type="float32")
    out = pipe(image, mask, *extra, **kw)
    assert out.shape == (1, 32, 32, 3) and np.isfinite(out).all()
    np.testing.assert_array_equal(pipe(image, mask, *extra, **kw), out)
