"""The ``.safetensors`` format, read and written with torch alone.

A file is an 8-byte little-endian header length N, N bytes of JSON, then
the tensors' raw little-endian bytes. The header maps each tensor name to
``{"dtype", "shape", "data_offsets": [begin, end]}`` (offsets into the
bytes after the header) and may hold a ``"__metadata__"`` map of strings.
The tensors' bytes follow one another with no gap, and the header is
padded with spaces to a multiple of 8 bytes, as the reference writer does.

The port reads checkpoints with its own reader because the GPU host has
no ``safetensors`` package. Each tensor is read into its own CPU
allocation, so a loaded state dict holds one copy of the file's bytes.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Mapping

import numpy as np
import torch

DTYPES = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I8": torch.int8, "U8": torch.uint8, "I32": torch.int32,
    "I64": torch.int64,
}
_NAMES = {v: k for k, v in DTYPES.items()}
_MAX_HEADER = 100 * 1024 * 1024


def _header(f, path: str) -> tuple:
    raw = f.read(8)
    if len(raw) != 8:
        raise ValueError(f"{path}: not a safetensors file (no header length)")
    (n,) = struct.unpack("<Q", raw)
    if n > _MAX_HEADER:
        raise ValueError(f"{path}: header of {n} bytes")
    header = json.loads(f.read(n))
    return header, 8 + n


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of the file, on the CPU, in its stored dtype (the
    ``__metadata__`` entry is skipped)."""
    out = {}
    with open(path, "rb") as f:
        header, base = _header(f, path)
        entries = sorted(((k, v) for k, v in header.items()
                          if k != "__metadata__"),
                         key=lambda kv: kv[1]["data_offsets"][0])
        for name, info in entries:
            if info["dtype"] not in DTYPES:
                raise ValueError(f"{path}: {name} has dtype {info['dtype']}, "
                                 f"not one of {sorted(DTYPES)}")
            dtype = DTYPES[info["dtype"]]
            begin, end = info["data_offsets"]
            shape = [int(s) for s in info["shape"]]
            want = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
            if end - begin != want:
                raise ValueError(f"{path}: {name} spans {end - begin} bytes, "
                                 f"its shape {shape} needs {want}")
            buf = torch.empty(want, dtype=torch.uint8)
            f.seek(base + begin)
            if f.readinto(buf.numpy()) != want:
                raise ValueError(f"{path}: {name} is cut short")
            out[name] = buf.view(dtype).reshape(shape)
    return out


def save_file(tensors: Mapping[str, object], path: str) -> None:
    """Write ``tensors`` (torch tensors on any device, or numpy arrays) in
    the order given."""
    items = []
    offset = 0
    header: Dict[str, object] = {}
    for name, t in tensors.items():
        t = torch.as_tensor(t).detach().cpu().contiguous()
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} is not one of "
                             f"{sorted(DTYPES)}")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        items.append(t)
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in items:
            f.write(memoryview(t.reshape(-1).view(torch.uint8).numpy()))
