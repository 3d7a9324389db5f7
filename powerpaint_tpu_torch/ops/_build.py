"""Build the CUDA sources under ``csrc/`` with nvcc, and the host natives
under the repository's ``native/`` with g++, and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on first use into a shared library with
a plain C interface, ``_build/lib<name>-<hash>.so`` inside the package
(``_build/`` is git-ignored), named by a hash of the source, the shared
headers ``csrc/*.cuh`` and the flags, so an edited source is rebuilt. A
library of ``DEFINED`` is another source built with a macro defined: the
flash kernel's bf16-softmax mode is ``flash_attention.cu`` with
``PPT_FLASH_BF16_SOFTMAX``, so that the main paths' library does not
compile its instantiations.
Nothing is built when a module is imported: nvcc and the card exist only
on the GPU host.

The host natives (``native/image_ops.cpp``, ``native/bpe_tokenizer.cpp``)
build the same way with the flags of ``native/build.sh`` into
``_build/libppt_<name>-<hash>.so``; the JAX package's own copies under
``powerpaint_tpu/native/`` are never read. Every build writes a file named
by its process id and renames it into place, so processes that build at
once leave one whole library.

``built_libraries`` lists what is built for the sources as they are now,
and ``install`` writes a library from bytes the same way: the cold-start
cache (``io.aot``) carries ``_build/`` from one process to another.
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
NATIVE = Path(__file__).resolve().parent.parent.parent / "native"
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


# library -> (the source it is built from, its extra nvcc flags)
DEFINED = {"flash_attention_bf16_softmax": ("flash_attention",
                                            ("-DPPT_FLASH_BF16_SOFTMAX",))}


def _source(name: str):
    """(source path, nvcc flags) of library ``name``."""
    src, extra = DEFINED.get(name, (name, ()))
    return CSRC / f"{src}.cu", NVCC_FLAGS + extra


def library_path(name: str) -> Path:
    src, flags = _source(name)
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(flags).encode())
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
    src, flags = _source(name)
    cmd = [nvcc_path(), *flags, "-o", str(tmp), str(src)]
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


SOURCES = ("flash_attention", "flash_attention_bf16_softmax", "conv3x3",
           "conv3x3_int8", "group_norm", "layer_norm")

# native/<source>.cpp -> the library's name and native/build.sh's flags
NATIVE_SOURCES = {"image": ("image_ops", ("-O3", "-shared", "-fPIC",
                                          "-std=c++17", "-march=native")),
                  "bpe": ("bpe_tokenizer", ("-O3", "-shared", "-fPIC",
                                            "-std=c++17"))}


@functools.lru_cache(maxsize=None)
def _native_target() -> str:
    """What ``-march=native`` means to this host's g++ (its ``-march=`` and
    ``-mtune=`` lines): a build for one CPU is not reused on another."""
    cxx = shutil.which("g++")
    if cxx is None:
        return ""
    out = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                         capture_output=True, text=True).stdout
    return " ".join(line.split()[-1] for line in out.splitlines()
                    if line.strip().startswith(("-march=", "-mtune=")))


def native_library_path(name: str) -> Path:
    source, flags = NATIVE_SOURCES[name]
    key = " ".join(flags)
    if "-march=native" in flags:
        key += " " + _native_target()
    digest = hashlib.sha256((NATIVE / f"{source}.cpp").read_bytes() + key.encode())
    return BUILD_DIR / f"libppt_{name}-{digest.hexdigest()[:12]}.so"


@functools.lru_cache(maxsize=None)
def load_native(name: str) -> ctypes.CDLL:
    """The loaded host library ``name`` ("image" or "bpe"), compiled with
    g++ from ``native/`` if it is not built yet; raises with the compiler's
    output when it cannot be built."""
    out = native_library_path(name)
    if not out.exists():
        source, flags = NATIVE_SOURCES[name]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError(f"g++ not found: native/{source}.cpp cannot "
                               "be built")
        proc = subprocess.run(
            [cxx, *flags, "-o", str(tmp), str(NATIVE / f"{source}.cpp")],
            capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed for native/{source}.cpp (exit "
                               f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))


def built_libraries() -> Dict[str, Path]:
    """The libraries built for the sources as they are now, by key:
    ``cuda:<name>`` for ``csrc/<name>.cu`` and ``native:<name>`` for a host
    native; a source without its current library is left out."""
    paths = {f"cuda:{n}": library_path(n) for n in SOURCES}
    paths.update({f"native:{n}": native_library_path(n) for n in NATIVE_SOURCES})
    return {k: p for k, p in paths.items() if p.exists()}


def current_library_path(key: str) -> Path:
    """Where the library of ``key`` (``cuda:<name>`` or ``native:<name>``)
    is built for the sources, headers and flags as they are now."""
    kind, _, name = key.partition(":")
    if kind == "cuda" and name in SOURCES:
        return library_path(name)
    if kind == "native" and name in NATIVE_SOURCES:
        return native_library_path(name)
    raise KeyError(f"no library {key!r}")


def install(filename: str, data: bytes) -> Path:
    """Write a library's bytes into ``BUILD_DIR`` as ``filename``, through a
    file named by the process id renamed into place, as a build does."""
    out = BUILD_DIR / filename
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    tmp.write_bytes(data)
    os.replace(tmp, out)
    return out
