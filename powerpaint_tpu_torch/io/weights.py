"""Model construction, random weights and weight import.

- ``build_models``: the modules of a config, built without allocating
  (meta device) so weights can be assigned directly: unet, vae and
  text_encoder for ppt-v1, and controlnet when the config has one; for
  ppt-v2 also brushnet and text_encoder_brushnet (the task-token tower of
  the branch), with text_encoder then the base UNet's plain tower (no task
  rows), the JAX package's parameter families.
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
  ``brushnet_down_blocks.<i>`` / ``brushnet_up_blocks.<i>``; for the
  ControlNet branch, ``controlnet_down_blocks_<i>`` as
  ``controlnet_down_blocks.<i>`` and the conditioning embedding's
  ``blocks_<k>`` as ``controlnet_cond_embedding.blocks.<k>`` (elsewhere
  ``blocks_<k>`` is a transformer's ``transformer_blocks.<k>``); for an
  IP-Adapter UNet, adapter a's ``encoder_hid_proj`` / ``to_k_ip`` /
  ``to_v_ip`` (a = 0) or ``..._<a>`` as ``encoder_hid_proj.<a>`` /
  ``to_k_ip.<a>`` / ``to_v_ip.<a>``; for the T2I-Adapter, ``body_<i>`` as
  ``body.<i>``.

ppt-v2 with an IP-Adapter image tower (``config.image_encoder``) has the
family ``image_encoder`` too (transformers ``CLIPVisionModelWithProjection``
names), built, drawn and loaded after the others.

Multi-ControlNet: ``state["controlnet"]`` (and the JAX tree of the family)
may be one branch or a list of them; ``load_models`` then gives a
``ModuleList`` of branches, one per entry.

The annotator and safety-checker networks (``ANNOTATOR_FAMILIES``) are
single modules with the published checkpoints' own state-dict names:
``build_annotator``, ``random_annotator_state`` and ``load_annotator``
(a state dict or a local checkpoint file), and their ``params_from_jax``
families invert the JAX package's ``convert_dpt``, ``convert_hed``,
``convert_bodypose``, ``convert_safety_checker`` and
``convert_clip_vision``.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from powerpaint_tpu_torch.core.config import (
    CLIPVisionConfig,
    PowerPaintConfig,
    dpt_hybrid_midas_config,
    safety_checker_config,
)
from powerpaint_tpu_torch.io.convert import load_state_dict
from powerpaint_tpu_torch.models.annotators import BodyPoseModel, HEDNetwork
from powerpaint_tpu_torch.models.brushnet import BrushNetModel
from powerpaint_tpu_torch.parallel.mesh import shard_model, shard_state
from powerpaint_tpu_torch.models.clip_vision import (
    CLIPVisionModelWithProjection,
    StableDiffusionSafetyChecker,
)
from powerpaint_tpu_torch.models.controlnet import ControlNetModel
from powerpaint_tpu_torch.models.dpt import DPTDepthModel
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
CN_FAMILIES = FAMILIES + ("controlnet",)  # ppt-v1 + ControlNet
ANNOTATOR_FAMILIES = ("dpt", "hed", "bodypose", "safety_checker", "clip_vision")


def build_models(config: PowerPaintConfig,
                 device="meta") -> Dict[str, nn.Module]:
    with torch.device(device):
        models = {"unet": UNet2DConditionModel(config.unet),
                  "vae": AutoencoderKL(config.vae)}
        if config.brushnet is None:
            models["text_encoder"] = CLIPTextModel(config.text_encoder)
            if config.controlnet is not None:
                models["controlnet"] = ControlNetModel(config.controlnet)
            return models
        models["text_encoder"] = CLIPTextModel(
            config.text_encoder.replace(num_external_tokens=0))
        models["brushnet"] = BrushNetModel(config.brushnet)
        models["text_encoder_brushnet"] = CLIPTextModel(config.text_encoder)
        if config.image_encoder is not None:
            models["image_encoder"] = CLIPVisionModelWithProjection(
                config.image_encoder)
        return models


def _init_param(module: nn.Module, name: str, shape, generator, device):
    if isinstance(module, (GroupNorm, LayerNorm, nn.LayerNorm)):
        fill = torch.ones if name == "weight" else torch.zeros
        return fill(shape, device=device)
    if isinstance(module, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
        if name == "bias":
            return torch.zeros(shape, device=device)
        # lecun normal, as flax's default (a transposed conv's weight is
        # (in, out, kh, kw): its fan-in is in * kh * kw / stride^2, here
        # taken as out * kh * kw, equal for the square ones DPT has)
        fan_in = int(np.prod(shape[1:]))
        w = torch.randn(shape, generator=generator, device=device)
        return w.mul_(fan_in ** -0.5)
    if name.endswith("embeds_weights"):
        # the safety checker's per-concept cosine thresholds: about 0.2,
        # far above the cosine of two random directions in 768-d (standard
        # deviation 0.036), so random weights flag nothing
        w = torch.randn(shape, generator=generator, device=device)
        return w.mul_(0.01).add_(0.2)
    # embedding tables, task-token rows, class tokens, positions, concepts
    return torch.randn(shape, generator=generator, device=device).mul_(0.02)


# E[silu(z)^2] = 0.356 for z ~ N(0, 1): the gain that keeps the second
# moment through a conv and a SiLU
_SILU_GAIN = 0.356 ** -0.5


def random_state(model: nn.Module, generator: torch.Generator, device="cuda",
                 dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """Random weights for one module (built on any device, meta too), in
    ``init_state``'s draw order and dtypes. The ControlNet conditioning
    embedding's convs (eight, each followed by a SiLU but the last) are
    drawn with ``_SILU_GAIN``: at lecun scale the control image's signal
    would shrink by 0.6 a layer and reach the branch at about 3% of the
    latent's, and the image would barely depend on it."""
    sd = {}
    for mod_name, module in model.named_modules():
        gain = (_SILU_GAIN if mod_name.startswith("controlnet_cond_embedding.")
                else 1.0)
        for p_name, p in module.named_parameters(recurse=False):
            value = _init_param(module, p_name, tuple(p.shape), generator,
                                device)
            if isinstance(module, (nn.Linear, nn.Conv2d)):
                if p_name == "weight":
                    value = value.mul_(gain)
                value = value.to(dtype)
            sd[f"{mod_name}.{p_name}" if mod_name else p_name] = value
    return sd


def init_state(config: PowerPaintConfig, generator: torch.Generator,
               device="cuda",
               dtype: torch.dtype = torch.float32) -> Dict[str, Dict[str, torch.Tensor]]:
    """Random weights for every family, made on ``device`` from
    ``generator`` (which must live on that device). Linear and conv weights
    are returned in ``dtype``; norm parameters and embeddings in fp32.
    Every conv gets random weights, the BrushNet and ControlNet zero convs
    and the ControlNet embedding's conv_out too: with zeros the branch would
    add nothing and a fault in it would pass every check. The families are
    drawn in ``build_models``' order, so ppt-v1's come out the same with or
    without a ControlNet."""
    return {family: random_state(model, generator, device, dtype)
            for family, model in build_models(config).items()}


# ---------------------------------------------------------------------------
# JAX parameter tree -> state dict
# ---------------------------------------------------------------------------

# JAX scope "<name>_<k>" that is entry k of a torch ModuleList "<name>"
_LISTS = {"down_blocks": "down_blocks", "up_blocks": "up_blocks",
          "resnets": "resnets", "attentions": "attentions",
          "downsamplers": "downsamplers", "upsamplers": "upsamplers",
          "blocks": "transformer_blocks", "layers": "layers",
          "brushnet_down_blocks": "brushnet_down_blocks",
          "brushnet_up_blocks": "brushnet_up_blocks",
          "controlnet_down_blocks": "controlnet_down_blocks",
          "to_k_ip": "to_k_ip", "to_v_ip": "to_v_ip",
          "encoder_hid_proj": "encoder_hid_proj", "body": "body"}
# the first IP-Adapter's scopes carry no index in the JAX tree
_FIRST_ADAPTER = ("to_k_ip", "to_v_ip", "encoder_hid_proj")
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
        if m and i > 0 and path[i - 1] == "controlnet_cond_embedding":
            parts += [m.group(1), m.group(2)]  # the embedding's conv list
        elif m and m.group(1) in _LISTS:
            parts += [_LISTS[m.group(1)], m.group(2)]
        elif p == "to_out":
            parts += ["to_out", "0"]
        elif p in _FIRST_ADAPTER:
            parts += [p, "0"]
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


def _clip(tree: dict, tokenizer=None) -> Dict[str, np.ndarray]:
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
            if tokenizer is None:
                blocks = [(n, len(arr) // len(TASK_TOKEN_ORDER))
                          for n in TASK_TOKEN_ORDER]
            else:
                blocks = [(p, len(names))
                          for p, names in tokenizer.token_map.items()]
            sizes = [k for _, k in blocks]
            if sum(sizes) != len(arr):
                raise ValueError(f"{len(arr)} external rows, the placeholders "
                                 f"{blocks} take {sum(sizes)}")
            for (name, _), rows in zip(blocks,
                                       np.split(arr, np.cumsum(sizes)[:-1])):
                sd[f"{emb}token_embedding.trainable_embeddings.{name}"] = rows
        elif top == "final_layer_norm":
            sd["text_model." + _torch_key(path)] = arr
        else:  # layers_<i>/...: fc1/fc2 live under mlp
            path = tuple("mlp." + p if p in ("fc1", "fc2") else p for p in path)
            sd["text_model.encoder." + _torch_key(path)] = _torch_tensor(path, arr)
    return sd


def _clip_vision(vm: dict, prefix: str) -> Dict[str, np.ndarray]:
    """A JAX ``CLIPVisionModel`` tree -> transformers names under
    ``prefix``."""
    sd = {}
    for path, arr in _flatten(vm):
        if path[0] == "embeddings":
            name = path[1]
            if name == "patch_embedding":
                arr = _torch_tensor(path, arr)
            key = name + (".weight" if name != "class_embedding" else "")
            sd[f"{prefix}embeddings.{key}"] = arr
        else:  # pre / post LayerNorm, encoder/layers_<i>/...
            path = tuple("mlp." + p if p in ("fc1", "fc2") else p for p in path)
            sd[prefix + _torch_key(path)] = _torch_tensor(path, arr)
    return sd


def _safety(tree: dict, tower: str) -> Dict[str, np.ndarray]:
    sd = _clip_vision(tree["vision_model"], tower)
    sd["visual_projection.weight"] = np.ascontiguousarray(
        np.asarray(tree["visual_projection"]["kernel"]).T)
    for k in ("concept_embeds", "special_care_embeds",
              "concept_embeds_weights", "special_care_embeds_weights"):
        if k in tree:
            sd[k] = np.asarray(tree[k])
    return sd


def _leaf(path: Tuple[str, ...], arr: np.ndarray) -> Tuple[str, np.ndarray]:
    """The last path element as a torch parameter name, with the array in
    torch layout."""
    name = "weight" if path[-1] in ("kernel", "scale") else path[-1]
    return name, _torch_tensor(path, arr)


_DPT_BIT = "dpt.embeddings.backbone.bit."
_DPT_LAYER = {"attention": "attention.attention", "attention_out":
              "attention.output.dense", "intermediate": "intermediate.dense",
              "output": "output.dense"}
_DPT_UNIT_RE = re.compile(r"^stage(\d+)_unit(\d+)$")


def _dpt_scope(path: Tuple[str, ...]) -> str:
    """HF ``DPTForDepthEstimation`` module path of a JAX DPT scope (all
    but the leaf), the inverse of ``convert_dpt``'s renames."""
    top, rest = path[0], list(path[1:])
    if top == "backbone":
        m = _DPT_UNIT_RE.match(rest[0])
        if m:
            sub = {"downsample_conv": "downsample.conv",
                   "downsample_norm": "downsample.norm"}.get(rest[1], rest[1])
            return (f"{_DPT_BIT}encoder.stages.{m.group(1)}.layers."
                    f"{m.group(2)}.{sub}")
        return _DPT_BIT + {"stem_conv": "embedder.convolution",
                           "stem_norm": "embedder.norm"}[rest[0]]
    if top == "vit":
        if rest[0].startswith("layer_"):
            i = rest[0][len("layer_"):]
            return f"dpt.encoder.layer.{i}." + ".".join(
                [_DPT_LAYER.get(rest[1], rest[1])] + rest[2:])
        return "dpt.embeddings." + ".".join(rest)
    m = _LIST_RE.match(top)
    name, i = m.group(1), m.group(2)
    stage = "neck.reassemble_stage."
    return {"readout_project": f"{stage}readout_projects.{i}.0",
            "reassemble_projection": f"{stage}layers.{i}.projection",
            "reassemble_resize": f"{stage}layers.{i}.resize",
            "neck_conv": f"neck.convs.{i}",
            "fusion": f"neck.fusion_stage.layers.{i}",
            "head": f"head.head.{i}"}[name] + "".join("." + p for p in rest)


def _dpt(tree: dict, config) -> Dict[str, np.ndarray]:
    """JAX ``DPTDepthModel`` tree -> HF names. A transposed-conv resize
    (factor > 1 in ``config``) goes from flax's (kh, kw, in, out) to
    torch's (in, out, kh, kw) with its taps reversed: flax's
    ``ConvTranspose`` correlates where torch's convolves, so this is the
    weight under which both compute the same map. (``convert_dpt`` does not
    reverse them, so an HF checkpoint with such a resize reaches the JAX
    model with the taps reversed: ROADMAP Queue C.) The two entries the JAX
    model never creates, since the depth head never reads them, are
    filled: ``dpt.layernorm`` (ones, zeros) and the deepest fusion layer's
    ``residual_layer1`` (zeros)."""
    deconv = {f"reassemble_resize_{i}"
              for i, f in enumerate(config.reassemble_factors) if f > 1}
    sd = {}
    for path, arr in _flatten(tree):
        if len(path) == 2 and path[0] == "vit" and path[1] in (
                "cls_token", "position_embeddings"):
            sd["dpt.embeddings." + path[1]] = arr
            continue
        scope = _dpt_scope(path[:-1])
        if path[0] in deconv and path[-1] == "kernel":
            sd[scope + ".weight"] = np.ascontiguousarray(
                np.transpose(arr, (2, 3, 0, 1))[:, :, ::-1, ::-1])
            continue
        name, arr = _leaf(path, arr)
        sd[f"{scope}.{name}"] = arr
    d = config.hidden_size
    sd.setdefault("dpt.layernorm.weight", np.ones(d, np.float32))
    sd.setdefault("dpt.layernorm.bias", np.zeros(d, np.float32))
    c = config.fusion_hidden_size
    unused = "neck.fusion_stage.layers.0.residual_layer1."
    for conv in ("convolution1", "convolution2"):
        sd.setdefault(f"{unused}{conv}.weight", np.zeros((c, c, 3, 3), np.float32))
        sd.setdefault(f"{unused}{conv}.bias", np.zeros(c, np.float32))
    return sd


def _annotator(tree: dict) -> Dict[str, np.ndarray]:
    """HED / body-pose trees: ``<name>_<k>`` (an ``nn.Sequential`` entry
    in HED) -> ``<name>.<k>``; the body-pose names have no such suffix."""
    sd = {}
    for path, arr in _flatten(tree):
        m = re.match(r"^(net[A-Za-z]+)_(\d+)$", path[0])
        scope = f"{m.group(1)}.{m.group(2)}" if m else path[0]
        name, arr = _leaf(path, arr)
        sd[f"{scope}.{name}"] = arr
    return sd


def _lora(tree: dict) -> Dict[str, Dict[str, np.ndarray]]:
    """A JAX ``train/lora.py`` factor tree (flax paths, down (I, r), up (r,
    O)) -> the port's (``train/lora.py``: module names, down (r, I), up (O,
    r))."""
    out = {}
    for path, arr in _flatten(tree):
        name = _torch_key(path[:-1] + ("kernel",))[:-len(".weight")]
        out.setdefault(name, {})[path[-1]] = np.ascontiguousarray(arr.T)
    return out


def params_from_jax(tree, family: str, config=None, tokenizer=None):
    """JAX-package parameter tree of one family (``unet``, ``vae``,
    ``text_encoder``, ``brushnet``, ``text_encoder_brushnet``,
    ``controlnet``, ``image_encoder``, ``t2i_adapter``, or one of
    ``ANNOTATOR_FAMILIES``) -> state dict of
    numpy arrays with the port's (and diffusers / transformers / the
    published checkpoints') names and layouts. A ``controlnet`` tuple or
    list of trees (Multi-ControlNet) gives a list of state dicts. ``dpt``
    takes its ``DPTConfig`` (the Intel/dpt-hybrid-midas one by default).
    A text tower's ``external_embedding`` rows split into one block per
    placeholder of ``tokenizer`` (the task tokens and any user token, in
    registration order), or evenly over the task tokens without one.

    ``family="lora"`` carries a JAX LoRA factor tree across (``_lora``), and
    ``family="stack"`` a JAX train state's parameters, ``{family: tree}``,
    to ``{family: state dict}``."""
    if family == "lora":
        return _lora(tree)
    if family == "stack":
        return {f: params_from_jax(t, f, tokenizer=tokenizer)
                for f, t in tree.items()}
    if family == "dpt":
        return _dpt(tree, config or dpt_hybrid_midas_config())
    if family in ("hed", "bodypose"):
        return _annotator(tree)
    if family == "safety_checker":
        return _safety(tree, "vision_model.vision_model.")
    if family in ("clip_vision", "image_encoder"):
        return _safety(tree, "vision_model.")
    if family == "controlnet" and isinstance(tree, (list, tuple)):
        return [_unet_or_vae(t) for t in tree]
    if family in ("unet", "brushnet", "controlnet", "t2i_adapter"):
        return _unet_or_vae(tree)
    if family == "vae":
        return _vae(tree)
    if family in ("text_encoder", "text_encoder_brushnet"):
        return _clip(tree, tokenizer)
    known = V2_FAMILIES + ("controlnet", "image_encoder", "t2i_adapter")
    raise ValueError(f"unknown family {family!r}; one of "
                     f"{known + ANNOTATOR_FAMILIES}")


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
                int8_x_scale: Optional[float] = None,
                tp=None) -> Dict[str, nn.Module]:
    """Build every family of ``config`` and assign ``state`` (state dicts
    of tensors or numpy arrays, strict names and shapes), on ``device``,
    with linear and conv weights in ``dtype``. Conv weights are stored
    channels-last, the layout of the NHWC activations, so cuDNN does not
    copy them into it on every call and the conv kernel of ``ops.conv``
    reads them as they are.

    ``int8_x_scale`` (the int8 W8A8 path's static activation scale, or None
    for off) quantises every ResNet unit's conv once, here: from the
    state's values as given, before the cast to ``dtype`` (the values the
    JAX package quantises), into non-persistent buffers (``Conv2D.set_int8``).

    ``state["controlnet"]``, one state dict or a list of them, gives a
    ``ModuleList`` with one branch per state dict.

    ``tp``, a model group (``parallel.mesh.Mesh.tp``), makes every model
    tensor-parallel over it: the modules are split first
    (``parallel.mesh.shard_model``), then each takes this rank's pieces of
    the whole weights in ``state``. None (the default) loads them whole."""
    out = {}
    for family, model in build_models(config).items():
        if family != "controlnet":
            out[family] = _load(model, state[family], device, dtype,
                                int8_x_scale, tp)
            continue
        branches = state[family]
        if isinstance(branches, dict):
            branches = [branches]
        with torch.device("meta"):
            models = [model] + [ControlNetModel(config.controlnet)
                                for _ in branches[1:]]
        out[family] = nn.ModuleList([
            _load(m, sd, device, dtype, int8_x_scale, tp)
            for m, sd in zip(models, branches)])
    return out


def _load(model: nn.Module, state: dict, device, dtype: torch.dtype,
          int8_x_scale: Optional[float], tp=None) -> nn.Module:
    """``state`` assigned to ``model``, on ``device``, as ``load_models``
    says."""
    if tp is not None:
        state = shard_state(state, shard_model(model, tp), tp.index)
    sd = {k: v if torch.is_tensor(v)
          else torch.from_numpy(np.ascontiguousarray(v))
          for k, v in state.items()}
    model.load_state_dict(sd, strict=True, assign=True)
    quantized = _quantize_resnets(model) if int8_x_scale is not None else []
    cast_compute(model.to(device), dtype)
    model.to(memory_format=torch.channels_last)
    # after the memory-format pass, which would restride the 4-D w_q
    for conv, w_q, w_scale, bias in quantized:
        conv.set_int8(w_q.to(device), w_scale.to(device), bias.to(device),
                      int8_x_scale)
    return model.eval().requires_grad_(False)


# ---------------------------------------------------------------------------
# annotators and the safety checker
# ---------------------------------------------------------------------------


def build_annotator(family: str, config=None, device="meta", state=None) -> nn.Module:
    """The module of one of ``ANNOTATOR_FAMILIES``, built on ``device``;
    ``config`` a ``DPTConfig`` (dpt) or ``CLIPVisionConfig`` (the CLIP
    families), the published one by default. The safety checker takes its
    concept counts from ``state`` where given (17 and 3 otherwise)."""
    with torch.device(device):
        if family == "dpt":
            return DPTDepthModel(config or dpt_hybrid_midas_config())
        if family == "hed":
            return HEDNetwork()
        if family == "bodypose":
            return BodyPoseModel()
        if family == "safety_checker":
            counts = {}
            if state is not None:
                counts = dict(num_concepts=int(state["concept_embeds"].shape[0]),
                              num_special=int(state["special_care_embeds"].shape[0]))
            return StableDiffusionSafetyChecker(
                config or safety_checker_config(), **counts)
        if family == "clip_vision":
            return CLIPVisionModelWithProjection(config or CLIPVisionConfig())
    raise ValueError(f"unknown family {family!r}; one of {ANNOTATOR_FAMILIES}")


def random_annotator_state(family: str, generator: torch.Generator,
                           device="cuda", config=None) -> Dict[str, torch.Tensor]:
    """Random fp32 weights for one annotator family at its full published
    width (or ``config``'s), made on ``device`` from ``generator`` with
    ``random_state``'s rules: lecun-normal weights, zero biases, unit norms,
    N(0, 0.02) tables, and the safety checker's thresholds near 0.2."""
    return random_state(build_annotator(family, config), generator, device)


def published_keys(family: str, state: dict) -> dict:
    """A checkpoint's state dict with the names the port's module takes:
    HED's ``module*`` -> ``net*`` (``network-bsds500.pth``), the body-pose
    ``model0.`` / ``model{s}_{b}.`` prefixes stripped, and the buffers the
    port does not keep (``position_ids``, ``num_batches_tracked``)
    dropped."""
    out = {}
    for k, v in state.items():
        if k.endswith(("position_ids", "num_batches_tracked")):
            continue
        if family == "hed":
            k = k.replace("module", "net")
        elif family == "bodypose":
            parts = k.split(".")
            if len(parts) == 3 and parts[0].startswith("model"):
                k = ".".join(parts[1:])
        out[k] = v
    return out


def load_annotator(family: str, state=None, *, checkpoint: Optional[str] = None,
                   config=None, device="cuda") -> nn.Module:
    """One of ``ANNOTATOR_FAMILIES`` on ``device`` in fp32, eval mode,
    from ``state`` (tensors or numpy arrays) or the file ``checkpoint``
    (``.safetensors``, read by the port's own reader, or a torch pickle),
    strict on names and shapes after ``published_keys``."""
    if state is None:
        if checkpoint is None:
            raise ValueError(f"{family}: need state or checkpoint")
        state = load_state_dict(checkpoint)
    state = published_keys(family, state)
    model = build_annotator(family, config, state=state)
    sd = {k: (v if torch.is_tensor(v)
              else torch.from_numpy(np.array(v, np.float32))).float()
          for k, v in state.items()}
    model.load_state_dict(sd, strict=True, assign=True)
    model.to(device).to(memory_format=torch.channels_last)
    return model.eval().requires_grad_(False)
