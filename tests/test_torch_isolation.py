"""The port stands alone: ``powerpaint_tpu_torch`` and ``chip_smoke.py``
import neither JAX nor anything of the JAX package."""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "powerpaint_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|flax|powerpaint_tpu)(?:\.|\s|$)",
    re.MULTILINE)


def test_importing_the_whole_port_loads_no_jax():
    modules = [".".join(p.relative_to(ROOT).with_suffix("").parts)
               for p in sorted(PORT.rglob("*.py"))]
    modules = [m[:-len(".__init__")] if m.endswith(".__init__") else m
               for m in modules]
    code = "\n".join(
        ["import importlib, sys"]
        + [f"importlib.import_module({m!r})" for m in modules]
        + ["import chip_smoke",
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


def test_the_pattern_catches_what_it_must():
    for line in ("import jax", "from jax import numpy", "import jax.numpy as jnp",
                 "from powerpaint_tpu.ops import attention",
                 "  from flax import linen"):
        assert FORBIDDEN.search(line), line
    for line in ("from powerpaint_tpu_torch.ops import norms",
                 "import jaxtyping_free", "# import jax"):
        assert not FORBIDDEN.search(line), line
