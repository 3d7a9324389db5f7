"""Cold-start cache: the built kernels, carried from one process to another.

The port of ``powerpaint_tpu/io/aot.py``. In the JAX package a cold start
pays tracing and XLA's compiles, and the cache holds a compiled
executable. The port runs eager PyTorch; what a cold process pays is the
build of its own code: nvcc for each CUDA source under ``csrc/`` and g++
for the host natives (``ops._build``). The cache file holds those
libraries, each under its hashed name (source, shared headers and flags;
for a native, also what ``-march=native`` means to this host's g++), so a
fresh process installs them into ``_build/`` and runs neither compiler.

Layout (the JAX package's): a magic line, an 8-byte little-endian length,
a JSON header, then the libraries' bytes back to back in the header's
order. The header names each library (its key, file name and byte count),
the card's name and compute capability, ``torch.__version__`` and
``torch.version.cuda``, and the compute mode (``POWERPAINT_INT8``).

``load`` checks the whole header before it writes anything and refuses a
file that does not match, naming the field: another card, torch, CUDA or
compute mode, a length that disagrees with the file, or a stale library,
one whose hashed name is not what ``ops._build`` computes for the sources
now (the port's counterpart of the JAX package's ``KERNEL_REV``). Callers
print ``aot: ignoring FILE: reason`` and build from the sources as usual.

Not ported: the JAX package's ``aot_proven`` / ``aot_drop`` /
``aot_repair_stale`` (signature misses, which kernels that take any shape
cannot have) and ``aot_redump`` (its benchmark's).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import torch

from powerpaint_tpu_torch.ops import _build

_MAGIC_LINE = b"PPTAOTT1\n"
_MAGIC = "powerpaint-torch-kernels-v1"


def _device_fields(device) -> Dict[str, Optional[str]]:
    """The header's fields that name the machine: the card (``"cpu"`` for
    a CPU device) and its compute capability, torch and its CUDA."""
    device = torch.device(device)
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        capability = "%d.%d" % torch.cuda.get_device_capability(device)
    else:
        name, capability = device.type, None
    return {"device": name, "capability": capability,
            "torch": torch.__version__, "cuda": torch.version.cuda}


def dump(path: str, device, mode: str) -> List[str]:
    """Write every library built for the sources as they are now into
    ``path``; returns their file names."""
    libs = _build.built_libraries()
    blobs = [p.read_bytes() for p in libs.values()]
    header = json.dumps(dict(
        magic=_MAGIC, mode=mode, **_device_fields(device),
        libraries=[{"key": k, "file": p.name, "bytes": len(b)}
                   for (k, p), b in zip(libs.items(), blobs)])).encode("utf-8")
    with open(path, "wb") as f:
        f.write(_MAGIC_LINE)
        f.write(len(header).to_bytes(8, "little"))
        f.write(header)
        for b in blobs:
            f.write(b)
    return [p.name for p in libs.values()]


def read_header(path: str) -> dict:
    """Parse and check the JSON preamble without reading any library."""
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC_LINE))
        if magic != _MAGIC_LINE:
            raise RuntimeError(f"{path}: not a powerpaint kernel cache file")
        hlen = int.from_bytes(f.read(8), "little")
        if not 0 < hlen <= 65536:
            raise RuntimeError(f"{path}: corrupt cache header")
        try:
            header = json.loads(f.read(hlen).decode("utf-8"))
        except ValueError as e:
            raise RuntimeError(f"{path}: corrupt cache header ({e})") from e
    if not isinstance(header, dict) or header.get("magic") != _MAGIC:
        raise RuntimeError(f"{path}: corrupt cache header magic")
    return header


def read(path: str) -> Dict[str, bytes]:
    """{file name: bytes} of every library in ``path``, after checking that
    the header's lengths account for the whole file."""
    header = read_header(path)
    with open(path, "rb") as f:
        f.seek(len(_MAGIC_LINE))
        start = len(_MAGIC_LINE) + 8 + int.from_bytes(f.read(8), "little")
        f.seek(start)
        data = f.read()
    want = sum(int(lib["bytes"]) for lib in header["libraries"])
    if len(data) != want:
        raise RuntimeError(f"{path}: libraries: {len(data)} bytes after the "
                           f"header, the header lists {want}")
    out, at = {}, 0
    for lib in header["libraries"]:
        n = int(lib["bytes"])
        out[lib["file"]] = data[at:at + n]
        at += n
    return out


def _check(header: dict, path: str, device, expect_mode: Optional[str]) -> None:
    """Raise naming the first header field that does not match this
    process, or a library that is stale for the sources as they are now."""
    here = _device_fields(device)
    for field in ("torch", "cuda", "device", "capability"):
        if header.get(field) != here[field]:
            raise RuntimeError(
                f"{path}: {field}: built with {header.get(field)!r}, "
                f"running {here[field]!r}")
    if expect_mode is not None and header.get("mode") != expect_mode:
        raise RuntimeError(
            f"{path}: mode: built in compute mode {header.get('mode')!r}, "
            f"running {expect_mode!r}")
    for lib in header["libraries"]:
        try:
            want = _build.current_library_path(lib["key"]).name
        except KeyError as e:
            raise RuntimeError(f"{path}: libraries: {e.args[0]}") from e
        if lib["file"] != want:
            raise RuntimeError(
                f"{path}: libraries: {lib['file']} is stale, the sources "
                f"build {want}")


def load(path: str, device, expect_mode: Optional[str] = None) -> List[str]:
    """Install the libraries of ``path`` into ``_build/`` so that
    ``ops._build`` finds them and runs no compiler; returns their file
    names. Every check runs before the first file is written."""
    header = read_header(path)
    _check(header, path, device, expect_mode)
    blobs = read(path)
    for name, data in blobs.items():
        _build.install(name, data)
    return list(blobs)


class AotPipelineMixin:
    """Pipeline-facing cache surface: ``aot_dump`` after a first call,
    ``aot_load`` in a fresh process before it."""

    _calls = 0  # calls dispatched by this pipeline

    def _aot_mode(self) -> str:
        """The compute mode baked into the file and enforced at load."""
        return f"int8={int(self.int8_x_scale is not None)}"

    def aot_dump(self, path: str, validate: bool = True) -> List[str]:
        """Write the libraries built so far (the first call builds those
        it launches) to ``path``; returns their file names.

        ``validate`` reads the file back and holds every library byte for
        byte to the built one; a bad file is deleted and RuntimeError
        raised."""
        if not self._calls:
            raise RuntimeError("call the pipeline once before aot_dump")
        names = dump(path, self.device, self._aot_mode())
        if validate:
            try:
                got = read(path)
                built = {p.name: p for p in _build.built_libraries().values()}
                if sorted(got) != sorted(names):
                    raise RuntimeError(f"libraries {sorted(got)}, dumped "
                                       f"{sorted(names)}")
                for name, data in got.items():
                    if data != built[name].read_bytes():
                        raise RuntimeError(f"{name} differs from the built "
                                           "library")
            except Exception as e:
                try:
                    os.remove(path)
                except OSError:
                    pass
                raise RuntimeError(f"aot_dump validation failed ({e})") from e
        return names

    def aot_load(self, path: str) -> List[str]:
        """Install the libraries of ``path`` (``load``); refuses a file for
        another card, torch, CUDA or compute mode, or a stale library."""
        return load(path, self.device, expect_mode=self._aot_mode())
