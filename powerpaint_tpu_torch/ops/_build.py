"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on first use into a shared library with
a plain C interface, ``_build/lib<name>-<hash>.so`` inside the package
(``_build/`` is git-ignored), named by a hash of the source and the flags so
an edited source is rebuilt. Nothing is built when a module is imported:
nvcc and the card exist only on the GPU host.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for one source; returns (process, tmp path, final path,
    log path) or None when the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = out.with_suffix(".log")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)
    return proc, tmp, out, log


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source that is not built yet, one nvcc process
    each, all started together. Returns {name: nvcc output} for the sources
    compiled by this call (register and shared-memory use from -Xptxas -v);
    raises with the compiler's output if any build fails."""
    started = {n: _start(n) for n in names}
    logs, errors = {}, []
    for name, job in started.items():
        if job is None:
            continue
        proc, tmp, out, log = job
        rc = proc.wait()
        text = log.read_text()
        if rc != 0:
            errors.append(f"nvcc failed for {name}.cu (exit {rc}):\n{text}")
            continue
        os.replace(tmp, out)
        logs[name] = text
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))


SOURCES = ("flash_attention", "conv3x3", "conv3x3_int8")
