"""Nothing the benchmark runs loads JAX or the JAX package: a fresh
interpreter imports every module of the benchmark and the served system's
modules a run uses, then lists the top-level names it holds."""

import json
import subprocess
import sys
from pathlib import Path

from benchmark.run import FORBIDDEN, forbidden_modules

ROOT = Path(__file__).resolve().parents[2]

PROBE = """
import importlib, json, pkgutil, sys
import benchmark, benchmark.metrics, benchmark.reference
for pkg in (benchmark, benchmark.metrics, benchmark.reference):
    for m in pkgutil.iter_modules(pkg.__path__):
        importlib.import_module(f"{pkg.__name__}.{m.name}")
for name in ("powerpaint_tpu_torch.pipelines.inpaint", "powerpaint_tpu_torch.pipelines.brushnet",
             "powerpaint_tpu_torch.serve.batcher", "powerpaint_tpu_torch.text.tokenizer",
             "powerpaint_tpu_torch.ops._build", "torch.profiler"):
    importlib.import_module(name)
from benchmark.run import forbidden_modules
print(json.dumps({"forbidden": forbidden_modules(),
                  "tops": sorted({m.split('.')[0] for m in sys.modules})}))
"""


def test_no_module_of_a_run_is_jax_or_the_jax_package():
    env = {"PATH": "/usr/bin:/bin", "USE_FLAX": "0", "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["forbidden"] == []
    assert "powerpaint_tpu_torch" in got["tops"]  # the system under test was loaded
    assert not set(got["tops"]) & set(FORBIDDEN)


def test_the_check_compares_whole_top_level_names():
    assert forbidden_modules(["powerpaint_tpu_torch", "powerpaint_tpu_torch.ops",
                              "jaxtyping", "flaxen.x"]) == []
    assert forbidden_modules(["powerpaint_tpu.models", "jax.numpy", "jaxlib",
                              "flax.linen"]) == ["flax", "jax", "jaxlib", "powerpaint_tpu"]
