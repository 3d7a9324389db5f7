"""Model construction, random weights and weight import.

- ``build_models``: the modules of a config, built without allocating
  (meta device) so weights can be assigned directly: unet, vae and
  text_encoder for ppt-v1; for ppt-v2 also brushnet and
  text_encoder_brushnet (the task-token tower of the branch), with
  text_encoder then the base UNet's plain tower (no task rows), the JAX
  package's parameter families.
- ``init_state``: random full-width weights made on a device from a
  generator (tests, the GPU smoke run; no checkpoint is needed).
- ``params_from_jax``: a JAX-package parameter tree (nested dicts of numpy
  arrays) to a diffusers / transformers named state dict. It inverts the
  JAX package's checkpoint converter (``io/convert.py``), with its own copy
  of the rules: list-module names (``resnets_0`` -> ``resnets.0``), HWIO ->
  OIHW conv kernels, (in, out) -> (out, in) linear kernels, ``scale`` ->
  ``weight``, the VAE's ``quant_conv`` / ``post_quant_conv`` back at the top
  level, and the CLIP ``external_embedding`` rows split back into the task
  tokens' ``trainable_embeddings``; for the BrushNet branch, the zero-conv
  lists ``brushnet_down_blocks_<i>`` / ``brushnet_up_blocks_<i>`` as
  ``brushnet_down_blocks.<i>`` / ``brushnet_up_blocks.<i>``.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from powerpaint_tpu_torch.core.config import PowerPaintConfig
from powerpaint_tpu_torch.models.brushnet import BrushNetModel
from powerpaint_tpu_torch.models.clip_text import (
    TASK_TOKEN_ORDER,
    CLIPTextModel,
)
from powerpaint_tpu_torch.models.layers import GroupNorm, LayerNorm, cast_compute
from powerpaint_tpu_torch.models.resnet import ResnetBlock2D
from powerpaint_tpu_torch.models.unet import UNet2DConditionModel
from powerpaint_tpu_torch.models.vae import AutoencoderKL
from powerpaint_tpu_torch.ops.conv import quantize_weights_int8

FAMILIES = ("unet", "vae", "text_encoder")  # ppt-v1
V2_FAMILIES = FAMILIES + ("brushnet", "text_encoder_brushnet")


def build_models(config: PowerPaintConfig,
                 device="meta") -> Dict[str, nn.Module]:
    with torch.device(device):
        models = {"unet": UNet2DConditionModel(config.unet),
                  "vae": AutoencoderKL(config.vae)}
        if config.brushnet is None:
            models["text_encoder"] = CLIPTextModel(config.text_encoder)
            return models
        models["text_encoder"] = CLIPTextModel(
            config.text_encoder.replace(num_external_tokens=0))
        models["brushnet"] = BrushNetModel(config.brushnet)
        models["text_encoder_brushnet"] = CLIPTextModel(config.text_encoder)
        return models


def _init_param(module: nn.Module, name: str, shape, generator, device):
    if isinstance(module, (GroupNorm, LayerNorm)):
        fill = torch.ones if name == "weight" else torch.zeros
        return fill(shape, device=device)
    if isinstance(module, (nn.Linear, nn.Conv2d)):
        if name == "bias":
            return torch.zeros(shape, device=device)
        fan_in = int(np.prod(shape[1:]))  # lecun normal, as flax's default
        w = torch.randn(shape, generator=generator, device=device)
        return w.mul_(fan_in ** -0.5)
    # embedding tables and task-token rows
    return torch.randn(shape, generator=generator, device=device).mul_(0.02)


def init_state(config: PowerPaintConfig, generator: torch.Generator,
               device="cuda",
               dtype: torch.dtype = torch.float32) -> Dict[str, Dict[str, torch.Tensor]]:
    """Random weights for every family, made on ``device`` from
    ``generator`` (which must live on that device). Linear and conv weights
    are returned in ``dtype``; norm parameters and embeddings in fp32.
    Every conv gets random weights, the BrushNet zero convs too: with
    zeros the branch would add nothing and a fault in it would pass every
    check."""
    state = {}
    for family, model in build_models(config).items():
        sd = {}
        for mod_name, module in model.named_modules():
            for p_name, p in module.named_parameters(recurse=False):
                value = _init_param(module, p_name, tuple(p.shape),
                                    generator, device)
                if isinstance(module, (nn.Linear, nn.Conv2d)):
                    value = value.to(dtype)
                sd[f"{mod_name}.{p_name}" if mod_name else p_name] = value
        state[family] = sd
    return state


# ---------------------------------------------------------------------------
# JAX parameter tree -> state dict
# ---------------------------------------------------------------------------

# JAX scope "<name>_<k>" that is entry k of a torch ModuleList "<name>"
_LISTS = {"down_blocks": "down_blocks", "up_blocks": "up_blocks",
          "resnets": "resnets", "attentions": "attentions",
          "downsamplers": "downsamplers", "upsamplers": "upsamplers",
          "blocks": "transformer_blocks", "layers": "layers",
          "brushnet_down_blocks": "brushnet_down_blocks",
          "brushnet_up_blocks": "brushnet_up_blocks"}
_LIST_RE = re.compile(r"^([a-z_]+)_(\d+)$")


def _flatten(tree: dict, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _torch_key(path: Tuple[str, ...]) -> str:
    parts = []
    for i, p in enumerate(path):
        m = _LIST_RE.match(p)
        if m and m.group(1) in _LISTS:
            parts += [_LISTS[m.group(1)], m.group(2)]
        elif p == "to_out":
            parts += ["to_out", "0"]
        elif i > 0 and path[i - 1] == "ff" and p in ("proj_in", "proj_out"):
            parts += ["net", "0", "proj"] if p == "proj_in" else ["net", "2"]
        elif p in ("kernel", "scale") and i == len(path) - 1:
            parts.append("weight")
        else:
            parts.append(p)
    return ".".join(parts)


def _torch_tensor(path: Tuple[str, ...], arr: np.ndarray) -> np.ndarray:
    if path[-1] == "kernel":
        if arr.ndim == 4:  # HWIO -> OIHW
            return np.ascontiguousarray(np.transpose(arr, (3, 2, 0, 1)))
        if arr.ndim == 2:  # (in, out) -> (out, in)
            return np.ascontiguousarray(arr.T)
    return arr


def _unet_or_vae(tree: dict) -> Dict[str, np.ndarray]:
    return {_torch_key(p): _torch_tensor(p, a) for p, a in _flatten(tree)}


def _vae(tree: dict) -> Dict[str, np.ndarray]:
    sd = {}
    for key, arr in _unet_or_vae(tree).items():
        for moved in ("quant_conv", "post_quant_conv"):
            for side in ("encoder.", "decoder."):
                if key.startswith(side + moved + "."):
                    key = key[len(side):]
        sd[key] = arr
    return sd


def _clip(tree: dict) -> Dict[str, np.ndarray]:
    emb = "text_model.embeddings."
    sd = {}
    for path, arr in _flatten(tree):
        top = path[0]
        if top == "token_embedding":
            wrapped = "wrapped." if "external_embedding" in tree else ""
            sd[f"{emb}token_embedding.{wrapped}weight"] = arr
        elif top == "position_embedding":
            sd[f"{emb}position_embedding.weight"] = arr
        elif top == "external_embedding":
            for name, rows in zip(TASK_TOKEN_ORDER,
                                  np.split(arr, len(TASK_TOKEN_ORDER))):
                sd[f"{emb}token_embedding.trainable_embeddings.{name}"] = rows
        elif top == "final_layer_norm":
            sd["text_model." + _torch_key(path)] = arr
        else:  # layers_<i>/...: fc1/fc2 live under mlp
            path = tuple("mlp." + p if p in ("fc1", "fc2") else p for p in path)
            sd["text_model.encoder." + _torch_key(path)] = _torch_tensor(path, arr)
    return sd


def params_from_jax(tree: dict, family: str) -> Dict[str, np.ndarray]:
    """JAX-package parameter tree of one family (``unet``, ``vae``,
    ``text_encoder``, ``brushnet`` or ``text_encoder_brushnet``) -> state
    dict of numpy arrays with the port's (and diffusers / transformers)
    names and layouts."""
    if family in ("unet", "brushnet"):
        return _unet_or_vae(tree)
    if family == "vae":
        return _vae(tree)
    if family in ("text_encoder", "text_encoder_brushnet"):
        return _clip(tree)
    raise ValueError(f"unknown family {family!r}; one of {V2_FAMILIES}")


def _quantize_resnets(model: nn.Module):
    """(conv, w_q, w_scale, fp32 bias) for every conv fed by a GroupNorm
    (``conv1`` / ``conv2`` of each ResNet unit), quantised from the weights
    as loaded."""
    out = []
    for m in model.modules():
        if isinstance(m, ResnetBlock2D):
            for conv in (m.conv1, m.conv2):
                w_q, w_scale = quantize_weights_int8(conv.weight.detach())
                out.append((conv, w_q, w_scale, conv.bias.detach().float()))
    return out


def load_models(config: PowerPaintConfig, state: Dict[str, dict], *,
                device, dtype: torch.dtype,
                int8_x_scale: Optional[float] = None) -> Dict[str, nn.Module]:
    """Build every family of ``config`` and assign ``state`` (state dicts
    of tensors or numpy arrays, strict names and shapes), on ``device``,
    with linear and conv weights in ``dtype``. Conv weights are stored
    channels-last, the layout of the NHWC activations, so cuDNN does not
    copy them into it on every call and the conv kernel of ``ops.conv``
    reads them as they are.

    ``int8_x_scale`` (the int8 W8A8 path's static activation scale, or None
    for off) quantises every ResNet unit's conv once, here: from the
    state's values as given, before the cast to ``dtype`` (the values the
    JAX package quantises), into non-persistent buffers (``Conv2D.set_int8``)."""
    out = {}
    for family, model in build_models(config).items():
        sd = {k: v if torch.is_tensor(v)
              else torch.from_numpy(np.ascontiguousarray(v))
              for k, v in state[family].items()}
        model.load_state_dict(sd, strict=True, assign=True)
        quantized = _quantize_resnets(model) if int8_x_scale is not None else []
        cast_compute(model.to(device), dtype)
        model.to(memory_format=torch.channels_last)
        # after the memory-format pass, which would restride the 4-D w_q
        for conv, w_q, w_scale, bias in quantized:
            conv.set_int8(w_q.to(device), w_scale.to(device), bias.to(device),
                          int8_x_scale)
        out[family] = model.eval().requires_grad_(False)
    return out
