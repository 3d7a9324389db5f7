"""Trainable LoRA factors on the port's state dicts, and their export: the
JAX package's ``train/lora.py``.

Training-side counterpart of ``io/lora.py`` (which loads and merges LoRA
checkpoints). Factors live in a tree keyed by the target module's name
(diffusers names, the port's own), ``{module: {"down": (r, I), "up": (O,
r)}}`` in torch orientation (the JAX package keeps flax's (I, r) / (r, O);
``io.weights.lora_from_jax`` carries a JAX tree across), with the standard
LoRA init (down ~ N(0, 1/sqrt(I)), up = 0, so training starts exactly at
the base model). ``apply_lora`` merges ``W + scale * up @ down`` in fp32
into the weights a loss runs on (``train.loss.make_lora_loss``): the merge
the JAX package traces, not an added branch, so the numbers are its
numbers and gradients flow into the factors.

``export_lora_sd`` emits the peft/diffusers key format
(``unet.<module>.lora_A.weight`` etc.) that ``io/lora.py``, the JAX
package's ``io/lora.py`` and any diffusers install load.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

# attention q/k/v/out + feed-forward projections (the standard SD LoRA
# target set: the JAX package's DEFAULT_TARGETS in diffusers names)
DEFAULT_TARGETS = (
    r".*\.(attn1|attn2)\.(to_q|to_k|to_v|to_out\.0)$|"
    r".*\.ff\.net\.(0\.proj|2)$|"
    r".*\.(q_proj|k_proj|v_proj|out_proj)$|.*\.(fc1|fc2)$"
)


def init_lora_tree(model: nn.Module, rank: int, generator: torch.Generator,
                   *, targets: str = DEFAULT_TARGETS,
                   device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """Factors over every ``nn.Linear`` of ``model`` (any device, meta too)
    whose name matches ``targets``, in module order, drawn from
    ``generator`` on ``device`` (the generator's by default)."""
    pat = re.compile(targets)
    device = generator.device if device is None else device
    out = {}
    for name, m in model.named_modules():
        if not (isinstance(m, nn.Linear) and pat.fullmatch(name)):
            continue
        o, i = m.weight.shape
        down = torch.randn((rank, i), generator=generator,
                           device=device) / np.sqrt(i)
        out[name] = {"down": down,
                     "up": torch.zeros((o, rank), device=device)}
    if not out:
        raise ValueError(f"no linear layer matched {targets!r}")
    return out


def apply_lora(params: Dict[str, torch.Tensor], lora: dict, *,
               scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """Merged weights ``W + scale * up @ down`` (in fp32, then W's dtype)
    at every factor site; the other entries shared."""
    out = dict(params)
    for name, f in lora.items():
        key = f"{name}.weight"
        w = params[key]
        delta = (f["up"].float() @ f["down"].float()) * scale
        out[key] = (w.float() + delta).to(w.dtype)
    return out


def export_lora_sd(lora: dict, *, target: str = "unet",
                   scale: float = 1.0) -> Dict[str, np.ndarray]:
    """Factor tree -> peft/diffusers state dict: lora_A (r, I), lora_B (O,
    r), alpha = rank, so loaders' alpha/rank factor is 1."""
    sd: Dict[str, np.ndarray] = {}
    for name, f in lora.items():
        down = f["down"].detach().float().cpu().numpy()
        up = f["up"].detach().float().cpu().numpy()
        base = f"{target}.{name}"
        sd[f"{base}.lora_A.weight"] = down * scale
        sd[f"{base}.lora_B.weight"] = up
        sd[f"{base}.alpha"] = np.float32(down.shape[0])
    return sd


def lora_param_count(lora: dict) -> int:
    return sum(int(t.numel()) for f in lora.values() for t in f.values())


def save_lora_npz(path: str, lora: dict, *, target: str = "unet",
                  scale: float = 1.0) -> None:
    np.savez(path, **export_lora_sd(lora, target=target, scale=scale))


def load_lora_npz(path: str) -> Dict[str, np.ndarray]:
    """A plain state dict loadable by ``io.lora.merge_lora``."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def zero_lora_like(lora: dict) -> Optional[dict]:
    return {n: {k: torch.zeros_like(t) for k, t in f.items()}
            for n, f in lora.items()}
