"""Seeded weights of a served configuration, made on the device.

The parameter names and shapes come from the plain reference's modules
(``reference.models.families``), built on the meta device; the served
system loads the same state dict by name. Each family's random values are
one ``torch.randn`` call on the device's generator, cut into parameters:

- linear and conv weights: standard normal over the square root of their
  fan-in (LeCun normal), so activations keep their scale through depth;
- linear and conv biases, token, task-token and position tables: normal
  with standard deviation 0.02;
- norm scales 1 + 0.05 z and norm shifts 0.02 z, so an affine parameter a
  kernel ignores changes the image.

Linear and conv parameters are made in the served dtype (bf16), every
other parameter in float32, the dtypes the served system computes with.
"""

from __future__ import annotations

import hashlib
from typing import Dict

import torch
from torch import nn

from benchmark.reference.models import TaskTokenTable, families


def _family_seed(seed: int, family: str) -> int:
    digest = hashlib.sha256(f"{int(seed)}/{family}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def _kind(module: nn.Module, name: str, full: str) -> str:
    if isinstance(module, (nn.Linear, nn.Conv2d)):
        return "weight" if name == "weight" else "bias"
    if isinstance(module, (nn.GroupNorm, nn.LayerNorm)):
        return "norm_scale" if name == "weight" else "norm_shift"
    if isinstance(module, (nn.Embedding, TaskTokenTable)) or "embedding" in full:
        return "table"
    raise ValueError(f"no initialiser for {type(module).__name__}.{name}")


def make_state(config: dict, seed: int, device,
               dtype: torch.dtype = torch.bfloat16) -> Dict[str, Dict[str, torch.Tensor]]:
    """{family: {name: tensor}} for ``config``, from ``seed``, on ``device``."""
    state = {}
    for family, model in families_on_meta(config).items():
        params = [(mod, pname, f"{mname}.{pname}" if mname else pname, tuple(p.shape))
                  for mname, mod in model.named_modules()
                  for pname, p in mod.named_parameters(recurse=False)]
        total = sum(int(torch.Size(s).numel()) for *_, s in params)
        g = torch.Generator(device=device).manual_seed(_family_seed(seed, family))
        z = torch.randn(total, generator=g, device=device)
        out, at = {}, 0
        for mod, pname, full, shape in params:
            n = int(torch.Size(shape).numel())
            v = z[at:at + n].view(shape)
            at += n
            kind = _kind(mod, pname, full)
            if kind == "weight":
                v = (v * float(torch.Size(shape[1:]).numel()) ** -0.5).to(dtype)
            elif kind == "bias":
                v = (v * 0.02).to(dtype)
            elif kind == "norm_scale":
                v = v * 0.05 + 1.0
            else:
                v = v * 0.02
            out[full] = v.contiguous()
        del z
        state[family] = out
    return state


def families_on_meta(config: dict) -> Dict[str, nn.Module]:
    with torch.device("meta"):
        return families(config)
