"""The port stands alone: ``powerpaint_tpu_torch``, ``chip_smoke.py`` and
the port's card script ``scripts/torch_perf_attn_bf16.py`` import neither
JAX nor anything of the JAX package."""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "powerpaint_tpu_torch"
SCRIPT = ROOT / "scripts" / "torch_perf_attn_bf16.py"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", SCRIPT]
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|flax|powerpaint_tpu)(?:\.|\s|$)",
    re.MULTILINE)


def test_importing_the_whole_port_loads_no_jax():
    modules = [".".join(p.relative_to(ROOT).with_suffix("").parts)
               for p in sorted(PORT.rglob("*.py"))]
    modules = [m[:-len(".__init__")] if m.endswith(".__init__") else m
               for m in modules]
    code = "\n".join(
        ["import importlib, importlib.util, sys"]
        + [f"importlib.import_module({m!r})" for m in modules]
        + ["import chip_smoke",
           "spec = importlib.util.spec_from_file_location('s', "
           f"{str(SCRIPT)!r})",
           "spec.loader.exec_module(importlib.util.module_from_spec(spec))",
           "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
           "('jax', 'jaxlib', 'flax', 'powerpaint_tpu'))",
           "assert not bad, bad",
           "print(len(sys.modules))"])
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_the_source(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path.relative_to(ROOT)}: {hits}"


def test_the_entry_points_and_the_int8_path_are_covered():
    names = {str(p.relative_to(PORT)) for p in SOURCES if PORT in p.parents}
    assert {"controller.py", "serve/cli.py", "core/metrics.py",
            "core/safety.py", "ops/conv.py", "pipelines/common.py"} <= names


def test_the_controlnet_modules_are_covered_and_load_no_opencv():
    """The ControlNet path's modules are checked like the rest, and OpenCV
    (which the GPU host does not have) loads only when canny runs."""
    names = {str(p.relative_to(PORT)) for p in SOURCES if PORT in p.parents}
    assert {"models/controlnet.py", "pipelines/controlnet.py",
            "tasks/control.py"} <= names
    code = ("import sys\n"
            "import powerpaint_tpu_torch.controller\n"
            "import powerpaint_tpu_torch.pipelines.controlnet\n"
            "import powerpaint_tpu_torch.tasks.control\n"
            "assert 'cv2' not in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_the_pattern_catches_what_it_must():
    for line in ("import jax", "from jax import numpy", "import jax.numpy as jnp",
                 "from powerpaint_tpu.ops import attention",
                 "  from flax import linen"):
        assert FORBIDDEN.search(line), line
    for line in ("from powerpaint_tpu_torch.ops import norms",
                 "import jaxtyping_free", "# import jax"):
        assert not FORBIDDEN.search(line), line


def test_the_annotator_modules_are_covered_and_load_no_host_extras():
    """The annotators and the safety checker are checked like the rest, and
    import neither transformers nor OpenCV nor scipy: the GPU host has no
    transformers and no OpenCV, and scipy loads only for the pose decode."""
    names = {str(p.relative_to(PORT)) for p in SOURCES if PORT in p.parents}
    assert {"models/dpt.py", "models/annotators.py", "models/clip_vision.py",
            "tasks/pose.py", "core/safety.py"} <= names
    code = ("import sys\n"
            "import powerpaint_tpu_torch.controller\n"
            "import powerpaint_tpu_torch.io.weights\n"
            "import powerpaint_tpu_torch.tasks.pose\n"
            "import powerpaint_tpu_torch.core.safety\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('cv2', 'scipy', 'transformers'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_the_sampler_modules_are_covered():
    """Every sampler of the registry is a port module checked like the
    rest."""
    names = {str(p.relative_to(PORT)) for p in SOURCES if PORT in p.parents}
    assert {f"schedulers/{m}.py" for m in (
        "__init__", "common", "ddim", "pndm", "unipc", "dpm", "euler",
        "ancestral", "heun", "lms", "deis", "sde", "lcm")} <= names


def test_the_loader_modules_are_covered_and_load_no_safetensors_package():
    """The checkpoint, LoRA and textual-inversion modules are checked like
    the rest, and the port reads ``.safetensors`` files with its own reader:
    the GPU host has no ``safetensors`` package."""
    names = {str(p.relative_to(PORT)) for p in SOURCES if PORT in p.parents}
    assert {"io/safetensors.py", "io/convert.py", "io/checkpoint.py",
            "io/lora.py"} <= names
    code = ("import sys\n"
            "import powerpaint_tpu_torch\n"
            "import powerpaint_tpu_torch.io.checkpoint\n"
            "import powerpaint_tpu_torch.io.lora\n"
            "import powerpaint_tpu_torch.serve.cli\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] == "
            "'safetensors')\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_the_adapter_modules_are_covered():
    """The IP-Adapter and T2I-Adapter modules are checked like the rest."""
    names = {str(p.relative_to(PORT)) for p in SOURCES if PORT in p.parents}
    assert {"models/projection.py", "models/adapter.py",
            "models/transformer.py", "models/clip_vision.py",
            "io/convert.py", "pipelines/brushnet.py"} <= names


def test_the_serving_modules_are_covered_and_load_no_gradio():
    """The serving modules are checked like the rest, and importing them
    loads no gradio: the UI imports it only when it is launched."""
    names = {str(p.relative_to(PORT)) for p in SOURCES if PORT in p.parents}
    assert {"serve/app.py", "serve/batcher.py", "pipelines/async_dispatch.py",
            "io/aot.py"} <= names
    code = ("import sys\n"
            "import powerpaint_tpu_torch.serve.app\n"
            "import powerpaint_tpu_torch.serve.batcher\n"
            "import powerpaint_tpu_torch.pipelines.async_dispatch\n"
            "import powerpaint_tpu_torch.io.aot\n"
            "import powerpaint_tpu_torch.serve.cli\n"
            "assert 'gradio' not in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_the_train_modules_are_covered_and_draw_masks_without_opencv():
    """Training is checked like the rest, and draws its brush masks without
    OpenCV, which the GPU host does not have."""
    names = {str(p.relative_to(PORT)) for p in SOURCES if PORT in p.parents}
    assert {f"train/{m}.py" for m in ("__init__", "masks", "data", "loss",
                                      "step", "lora", "trainer", "distill",
                                      "cli")} | {"ops/_grad.py"} <= names
    code = ("import sys\n"
            "import numpy as np\n"
            "import powerpaint_tpu_torch.train.cli\n"
            "from powerpaint_tpu_torch.train import masks\n"
            "masks.random_mask(np.random.RandomState(0), 64, 64, 'mix')\n"
            "assert 'cv2' not in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_the_parallel_modules_are_covered_and_start_nothing_on_import():
    """The mesh modules are checked like the rest, and importing them
    joins no process group."""
    names = {str(p.relative_to(PORT)) for p in SOURCES if PORT in p.parents}
    assert {f"parallel/{m}.py" for m in ("__init__", "mesh", "collectives",
                                         "launch", "dryrun")} <= names
    code = ("import torch.distributed as dist\n"
            "import powerpaint_tpu_torch.parallel.dryrun\n"
            "import powerpaint_tpu_torch.parallel.launch\n"
            "assert not dist.is_initialized()\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_the_sequence_parallel_modules_are_covered_and_load_no_jax():
    """The ring, the row context and the modules they change are checked
    like the rest, and import neither JAX nor the JAX package."""
    names = {str(p.relative_to(PORT)) for p in SOURCES if PORT in p.parents}
    assert {"ops/ring_attention.py", "parallel/sequence.py",
            "ops/attention.py", "parallel/collectives.py",
            "ops/freeu.py"} <= names
    code = ("import sys\n"
            "import powerpaint_tpu_torch.ops.ring_attention\n"
            "import powerpaint_tpu_torch.parallel.sequence\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'powerpaint_tpu'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


OPENCV_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+cv2(?:\.|\s|$)"
    r"|import_module\(\s*['\"]cv2|__import__\(\s*['\"]cv2",
    re.MULTILINE)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_opencv_import_in_the_source(path):
    """The GPU host has no OpenCV: no port module (nor ``chip_smoke.py``)
    imports it."""
    hits = OPENCV_IMPORT.findall(path.read_text())
    assert not hits, f"{path.relative_to(ROOT)}: {hits}"


def test_the_opencv_pattern_catches_what_it_must():
    for line in ("import cv2", "    import cv2", "from cv2 import resize",
                 "importlib.import_module('cv2')", '__import__("cv2")'):
        assert OPENCV_IMPORT.search(line), line
    for line in ("# cv2.resize", "x = cv2_like", '"""cv2.Canny"""'):
        assert not OPENCV_IMPORT.search(line), line


def test_every_control_map_is_made_without_opencv():
    """With ``cv2`` unimportable, every control type of the registry makes
    its map on the CPU: canny, HED (plain, safe, scribble, at a size off
    its bucket) and pose, with random full-width annotators at small
    inputs."""
    code = ("import sys\n"
            "sys.modules['cv2'] = None\n"
            "import numpy as np, torch\n"
            "torch.set_num_threads(1)\n"
            "from powerpaint_tpu_torch.io.weights import random_annotator_state\n"
            "from powerpaint_tpu_torch.tasks import control\n"
            "gen = lambda s: torch.Generator().manual_seed(s)\n"
            "img = (np.random.default_rng(0).random((70, 90, 3)) * 255)"
            ".astype(np.uint8)\n"
            "img[20:50, 30:70] = (220, 40, 90)\n"
            "out = {'canny': control.get_control_image('canny', img)}\n"
            "hed = control.register_hed(state=random_annotator_state('hed', gen(1), "
            "device='cpu'), detect_resolution=64, device='cpu')\n"
            "for safe, scribble in ((False, False), (True, False), (False, True)):\n"
            "    hed.safe, hed.scribble = safe, scribble\n"
            "    out[f'hed{int(safe)}{int(scribble)}'] = "
            "control.get_control_image('hed', img)\n"
            "control.register_openpose(state=random_annotator_state("
            "'bodypose', gen(2), device='cpu'), device='cpu')\n"
            "out['pose'] = control.get_control_image('pose', img[:48, :64])\n"
            "for k, v in out.items():\n"
            "    assert v.dtype == np.uint8 and v.shape[2] == 3, (k, v.shape)\n"
            "    assert v.shape[:2] == ((48, 64) if k == 'pose' else (70, 90)), k\n"
            "assert out['canny'].any() and out['hed00'].any()\n"
            "assert set(np.unique(out['hed01'])) <= {0, 255}\n"
            "assert 'cv2' not in sys.modules or sys.modules['cv2'] is None\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
