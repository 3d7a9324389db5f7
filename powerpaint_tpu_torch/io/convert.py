"""Checkpoint files to the port's state dicts (the port of
``powerpaint_tpu/io/convert.py``'s loading, key handling, single-file maps
and textual-inversion reader, with its own copy of the logic).

The port's modules carry diffusers / transformers parameter names, so a
diffusers UNet, BrushNet or VAE state dict and a transformers CLIP state
dict load as they are. What this module does to them:

- CLIP text: the ``position_ids`` buffer is dropped; with task tokens the
  table is PowerPaint's ``EmbeddingLayerWithFixes`` layout
  (``token_embedding.wrapped.weight`` and the ``trainable_embeddings.P_*``
  rows), which is the port's ``TaskTokenEmbedding``; a plain tower's
  ``token_embedding.weight`` stays plain.
- The VAE keeps ``quant_conv`` / ``post_quant_conv`` at its top level, as
  diffusers stores them; an asymmetric VAE's condition tower and decoder
  shapes are read from its keys (``infer_condition_layers``,
  ``infer_vae_decoder_config``).
- IP-Adapter files (``convert_ip_adapter``: the nested ``.bin`` layout
  and the flat ``.safetensors`` one) become UNet state-dict entries
  (``encoder_hid_proj.<a>``, each attn2's ``to_k_ip.<a>`` /
  ``to_v_ip.<a>``) that ``merge_ip_adapter`` adds to a UNet's; a
  T2I-Adapter state dict loads as it is (``convert_t2i_adapter``);
  ``brushnet_params_from_unet`` initialises a BrushNet branch from a
  UNet's weights.
- Original-SD single files (``model.diffusion_model.*``,
  ``first_stage_model.*``, ``cond_stage_model.transformer.*``) are renamed
  to those names: ``ldm_unet_to_diffusers``, ``ldm_vae_to_diffusers``
  (decoder levels reversed, the mid attention's 1x1 convs squeezed to
  linears).

Tensors stay torch tensors on the CPU in their stored dtype; the pipeline
casts them once, on the device (``io.weights.load_models``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from powerpaint_tpu_torch.core.config import (
    CROSS_ATTN_DOWN,
    CROSS_ATTN_UP,
    MID_CROSS_ATTN,
    CLIPVisionConfig,
    UNetConfig,
)
from powerpaint_tpu_torch.io import safetensors

_EMB = "text_model.embeddings.token_embedding."


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A state dict from a ``.safetensors`` file (the port's own reader), a
    numpy ``.npz`` (the train CLI's ``lora.npz``; no pickles) or a torch
    pickle (``.bin`` / ``.pth`` / ``.ckpt``, read with ``weights_only``; a
    top-level ``state_dict`` entry is unwrapped)."""
    if path.endswith(".safetensors"):
        return safetensors.load_file(path)
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as z:
            return {k: torch.from_numpy(z[k]) for k in z.files}
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return dict(sd)


# ---------------------------------------------------------------------------
# CLIP text
# ---------------------------------------------------------------------------


def convert_clip_text(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A transformers ``CLIPTextModel`` state dict, with or without the task
    rows, in the port's names."""
    trainable = any(".trainable_embeddings." in k for k in sd)
    out = {}
    for k, v in sd.items():
        if k.endswith("position_ids"):  # a transformers buffer
            continue
        if k in (_EMB + "weight", _EMB + "wrapped.weight"):
            k = _EMB + ("wrapped.weight" if trainable else "weight")
        out[k] = v
    return out


def text_table_rows(sd: Dict[str, torch.Tensor]) -> Tuple[int, int]:
    """(vocab rows, task rows) of a converted CLIP state dict: the counts
    the config and the tokenizer must take (the JAX ``_sync_text_config``)."""
    table = sd.get(_EMB + "wrapped.weight", sd.get(_EMB + "weight"))
    ext = sum(int(v.shape[0]) for k, v in sd.items()
              if k.startswith(_EMB + "trainable_embeddings."))
    return int(table.shape[0]), ext


# ---------------------------------------------------------------------------
# VAE and CLIP vision
# ---------------------------------------------------------------------------


def infer_condition_layers(sd) -> Tuple[Tuple[int, int, int], ...]:
    """(kernel, stride, out_ch) of each conv of an AsymmetricAutoencoderKL's
    ``decoder.condition_encoder``, from its shapes (3x3 stride 1, 4x4
    stride 2); empty for a plain VAE."""
    spec = []
    i = 0
    while f"decoder.condition_encoder.layers.{i}.weight" in sd:
        w = sd[f"decoder.condition_encoder.layers.{i}.weight"]  # OIHW
        k = int(w.shape[2])
        spec.append((k, 1 if k == 3 else 2, int(w.shape[0])))
        i += 1
    return tuple(spec)


def infer_vae_decoder_config(sd) -> dict:
    """The decoder's widths and depth from a VAE state dict's shapes
    (``VAEConfig`` fields): an asymmetric VAE's decoder is wider and deeper
    than its encoder."""
    n_blocks = 0
    while f"decoder.up_blocks.{n_blocks}.resnets.0.conv1.weight" in sd:
        n_blocks += 1
    chans, layers = [], 0
    for i in range(n_blocks):
        chans.append(int(sd[f"decoder.up_blocks.{i}.resnets.0.conv1.weight"].shape[0]))
        k = 0
        while f"decoder.up_blocks.{i}.resnets.{k}.conv1.weight" in sd:
            k += 1
        layers = max(layers, k - 1)
    return {"up_block_out_channels": tuple(reversed(chans)),
            "layers_per_up_block": layers}


def convert_clip_vision(sd) -> Dict[str, torch.Tensor]:
    """A transformers ``CLIPVisionModelWithProjection`` state dict in the
    port's names: the ``position_ids`` buffer dropped."""
    return {k: v for k, v in sd.items() if not k.endswith("position_ids")}


def infer_clip_vision_config(sd, config_json: Optional[dict] = None):
    """A ``CLIPVisionConfig`` from a CLIP vision (or safety checker) state
    dict's shapes: width, depth, patch and image size, projection. The
    heads, ``hidden_act`` and the LayerNorm eps come from the directory's
    ``config.json`` (``config_json``, its dict; transformers'
    ``CLIPVisionConfig`` defaults where it leaves one out); without one,
    heads at 64 channels each and ``quick_gelu``, as the JAX package
    infers them. That rule holds for ViT-L/14 (1024 wide, 16 heads) and
    not for the SD1.5 IP-Adapter's OpenCLIP ViT-H/14 (1280 wide, 16 heads
    of 80, exact ``gelu``), so the port reads the file where it can."""

    def get(*names):
        for n in names:
            if n in sd:
                return sd[n]
        raise KeyError(names)

    prefix = ("vision_model.vision_model."
              if "vision_model.vision_model.embeddings.class_embedding" in sd
              else "vision_model.")
    patch_w = get(prefix + "embeddings.patch_embedding.weight")  # (C,3,p,p)
    hidden = int(patch_w.shape[0])
    patch = int(patch_w.shape[-1])
    pos = get(prefix + "embeddings.position_embedding.weight")
    grid = int(round((pos.shape[0] - 1) ** 0.5))
    layers = 0
    while f"{prefix}encoder.layers.{layers}.layer_norm1.weight" in sd:
        layers += 1
    fc1 = get(prefix + "encoder.layers.0.mlp.fc1.weight",
              prefix + "encoder.layers.0.fc1.weight")
    proj = sd.get("visual_projection.weight")
    cfg = CLIPVisionConfig(
        hidden_size=hidden, intermediate_size=int(fc1.shape[0]),
        num_hidden_layers=layers, num_attention_heads=max(1, hidden // 64),
        image_size=grid * patch, patch_size=patch,
        projection_dim=int(proj.shape[0]) if proj is not None else hidden)
    if config_json is None:
        return cfg
    stated = config_json.get("hidden_size", hidden)
    if stated != hidden:
        raise ValueError(f"config.json gives hidden_size {stated}, the "
                         f"weights {hidden}")
    heads = int(config_json.get("num_attention_heads", 12))
    if hidden % heads:
        raise ValueError(f"{heads} heads do not divide width {hidden}")
    return cfg.replace(num_attention_heads=heads,
                       hidden_act=config_json.get("hidden_act", "quick_gelu"),
                       layer_norm_eps=float(config_json.get("layer_norm_eps",
                                                            1e-5)))


# ---------------------------------------------------------------------------
# IP-Adapter, T2I-Adapter, BrushNet from a UNet
# ---------------------------------------------------------------------------


def ip_adapter_attn2_paths(unet_cfg: UNetConfig) -> List[str]:
    """Module paths of every cross-attention (attn2) of the UNet in the
    order of diffusers' ``attn_processors``: down blocks, up blocks, then
    the mid block (the reference UNet registers ``down_blocks`` and
    ``up_blocks`` before ``mid_block``), so an IP-Adapter checkpoint's ids
    1, 3, 5, ... map to them in turn, as in the JAX package."""
    k_range = range(unet_cfg.transformer_layers_per_block)
    paths = []
    for i, kind in enumerate(unet_cfg.down_block_types):
        if kind == CROSS_ATTN_DOWN:
            paths += [f"down_blocks.{i}.attentions.{j}.transformer_blocks.{k}.attn2"
                      for j in range(unet_cfg.layers_per_block) for k in k_range]
    for i, kind in enumerate(unet_cfg.up_block_types):
        if kind == CROSS_ATTN_UP:
            paths += [f"up_blocks.{i}.attentions.{j}.transformer_blocks.{k}.attn2"
                      for j in range(unet_cfg.layers_per_block + 1)
                      for k in k_range]
    if unet_cfg.mid_block_type == MID_CROSS_ATTN:
        paths += [f"mid_block.attentions.0.transformer_blocks.{k}.attn2"
                  for k in k_range]
    return paths


def convert_ip_adapter(sd, unet_cfg: UNetConfig, adapter_index: int = 0) -> dict:
    """An IP-Adapter checkpoint -> the UNet state-dict entries of adapter
    ``adapter_index``: ``encoder_hid_proj.<a>.image_embeds`` /
    ``.norm`` and each attn2's ``to_k_ip.<a>`` / ``to_v_ip.<a>`` (torch
    layouts, as stored). Both layouts: the nested ``{"image_proj": {...},
    "ip_adapter": {"1.to_k_ip.weight": ...}}`` of ``ip-adapter_sd15.bin``
    and the flat ``image_proj.proj.weight`` / ``ip_adapter.1.to_k_ip.weight``
    keys. Add them to a UNet's with ``merge_ip_adapter``; a stack takes one
    file per adapter, with indices 0, 1, ..."""
    flat = {}
    for k, v in sd.items():
        if isinstance(v, dict):
            flat.update({f"{k}.{k2}": v2 for k2, v2 in v.items()})
        else:
            flat[k] = v

    def get(*names):
        for n in names:
            if n in flat:
                return flat[n]
        raise KeyError(f"ip-adapter checkpoint missing any of {names}")

    a = adapter_index
    proj = f"encoder_hid_proj.{a}."
    out = {proj + "image_embeds.weight": get("image_proj.proj.weight",
                                             "image_proj.image_embeds.weight"),
           proj + "image_embeds.bias": get("image_proj.proj.bias",
                                           "image_proj.image_embeds.bias"),
           proj + "norm.weight": get("image_proj.norm.weight"),
           proj + "norm.bias": get("image_proj.norm.bias")}
    for idx, path in enumerate(ip_adapter_attn2_paths(unet_cfg)):
        kid = 2 * idx + 1
        for name in ("to_k_ip", "to_v_ip"):
            out[f"{path}.{name}.{a}.weight"] = get(
                f"ip_adapter.{kid}.{name}.weight",
                f"ip_adapter.{kid}.{name}.{a}.weight")
    return out


def merge_ip_adapter(unet_sd: dict, ip_sd: dict) -> dict:
    """A new UNet state dict: ``unet_sd`` with ``convert_ip_adapter``'s
    entries added (the analog of diffusers ``load_ip_adapter``)."""
    return {**unet_sd, **ip_sd}


def ip_adapter_shape(sd) -> Tuple[int, int]:
    """(image embedding width, projection rows) of an IP-Adapter
    checkpoint in either layout: ``ip_adapter_dim``, and the tokens times
    the cross-attention width."""
    w = None
    for k, v in sd.items():
        if k.endswith("image_proj.proj.weight") or k == "proj.weight":
            w = v
        elif k == "image_proj" and isinstance(v, dict):
            w = v.get("proj.weight", w)
    if w is None:
        raise KeyError("ip-adapter checkpoint has no image_proj.proj.weight")
    return int(w.shape[1]), int(w.shape[0])


def convert_t2i_adapter(sd) -> dict:
    """A diffusers ``T2IAdapter`` (full adapter) state dict: the port's
    ``models.adapter.T2IAdapter`` has its names (``adapter.conv_in``,
    ``adapter.body.<i>.in_conv``, ``adapter.body.<i>.resnets.<j>.block1``
    / ``block2``), so it loads as it is."""
    return dict(sd)


_FROM_UNET = ("down_blocks", "up_blocks", "mid_block", "time_embedding")


def _unet_scope(key: str) -> str:
    """A state-dict key's top-level module: ``down_blocks.<i>`` /
    ``up_blocks.<i>``, else its first name."""
    parts = key.split(".")
    return ".".join(parts[:2]) if parts[0] in ("down_blocks", "up_blocks") \
        else parts[0]


def brushnet_params_from_unet(unet_sd: dict, template: dict) -> dict:
    """A BrushNet state dict initialised from a UNet's (the reference's
    ``BrushNetModel.from_unet``, as the JAX package computes it):
    ``conv_in_condition``'s input channels are [UNet conv_in | UNet
    conv_in | 0] and its bias the UNet's; the time embedding and every
    down, mid and up block the template shares with the UNet are the
    UNet's, whole; the rest (the zero convs) is ``template``'s, a BrushNet
    state dict of the right shapes (e.g. ``io.weights.random_state``)."""
    scopes = {_unet_scope(k) for k in template}
    taken = {s for s in map(_unet_scope, unet_sd)
             if s in scopes and s.split(".")[0] in _FROM_UNET}
    out = {k: v for k, v in template.items() if _unet_scope(k) not in taken}
    out.update({k: v for k, v in unet_sd.items() if _unet_scope(k) in taken})
    uw = torch.as_tensor(unet_sd["conv_in.weight"])  # (C, n_in, 3, 3)
    cw = torch.zeros_like(torch.as_tensor(template["conv_in_condition.weight"]))
    n = uw.shape[1]
    cw[:, :n] = uw
    cw[:, n:2 * n] = uw
    out["conv_in_condition.weight"] = cw
    out["conv_in_condition.bias"] = unet_sd["conv_in.bias"]
    return out


# ---------------------------------------------------------------------------
# original-SD single files
# ---------------------------------------------------------------------------


def _ldm_resnet(sub: str) -> str:
    return (sub.replace("in_layers.0", "norm1")
            .replace("in_layers.2", "conv1")
            .replace("emb_layers.1", "time_emb_proj")
            .replace("out_layers.0", "norm2")
            .replace("out_layers.3", "conv2")
            .replace("skip_connection", "conv_shortcut")
            .replace("nin_shortcut", "conv_shortcut"))


def ldm_unet_to_diffusers(sd, levels: int = 4, layers_per_block: int = 2):
    """``model.diffusion_model.*`` keys (prefix removed) -> diffusers UNet
    keys."""
    out = {}
    per = layers_per_block + 1  # input blocks per level (res, res, down)
    for key, v in sd.items():
        parts = key.split(".")
        if key.startswith("time_embed."):
            n = {"0": "linear_1", "2": "linear_2"}[parts[1]]
            out[f"time_embedding.{n}.{parts[2]}"] = v
        elif key.startswith("input_blocks.0.0."):
            out[f"conv_in.{parts[3]}"] = v
        elif key.startswith("input_blocks."):
            i = int(parts[1])
            lvl, j = (i - 1) // per, (i - 1) % per
            sub = ".".join(parts[3:])
            if j < layers_per_block:
                if parts[2] == "0":
                    out[f"down_blocks.{lvl}.resnets.{j}.{_ldm_resnet(sub)}"] = v
                else:  # the spatial transformer: names already diffusers'
                    out[f"down_blocks.{lvl}.attentions.{j}.{sub}"] = v
            else:  # input_blocks.{3,6,9}.0.op
                out[f"down_blocks.{lvl}.downsamplers.0.conv.{parts[-1]}"] = v
        elif key.startswith("middle_block."):
            sub = ".".join(parts[2:])
            if parts[1] == "0":
                out[f"mid_block.resnets.0.{_ldm_resnet(sub)}"] = v
            elif parts[1] == "1":
                out[f"mid_block.attentions.0.{sub}"] = v
            else:
                out[f"mid_block.resnets.1.{_ldm_resnet(sub)}"] = v
        elif key.startswith("output_blocks."):
            i = int(parts[1])
            lvl, j = i // per, i % per
            sub = ".".join(parts[3:])
            is_upsampler = sub.startswith("conv.") and (
                parts[2] != "0"
                and (i % per == per - 1 or i == levels * per - 1))
            if parts[2] == "0":
                out[f"up_blocks.{lvl}.resnets.{j}.{_ldm_resnet(sub)}"] = v
            elif is_upsampler:
                out[f"up_blocks.{lvl}.upsamplers.0.conv.{parts[-1]}"] = v
            else:
                out[f"up_blocks.{lvl}.attentions.{j}.{sub}"] = v
        elif key.startswith("out.0."):
            out[f"conv_norm_out.{parts[2]}"] = v
        elif key.startswith("out.2."):
            out[f"conv_out.{parts[2]}"] = v
    return out


def ldm_vae_to_diffusers(sd):
    """``first_stage_model.*`` keys (prefix removed) -> diffusers
    AutoencoderKL keys. LDM's ``decoder.up.0`` is the lowest resolution,
    diffusers' ``decoder.up_blocks.0`` the highest; LDM's mid attention
    q / k / v / proj_out are 1x1 convs, diffusers' linears."""
    n_up = 1 + max((int(k.split(".")[2]) for k in sd
                    if k.startswith("decoder.up.")), default=-1)
    out = {}

    def attn(name: str, v):
        m = {"q": "to_q", "k": "to_k", "v": "to_v", "proj_out": "to_out.0",
             "norm": "group_norm"}
        mod, param = name.split(".", 1)
        if v.ndim == 4 and mod in ("q", "k", "v", "proj_out"):
            v = v[:, :, 0, 0]
        return f"{m[mod]}.{param}", v

    for key, v in sd.items():
        parts = key.split(".")
        side = parts[0]
        if side in ("quant_conv", "post_quant_conv"):
            out[key] = v
        elif parts[1] in ("conv_in", "conv_out"):
            out[key] = v
        elif parts[1] == "norm_out":
            out[f"{side}.conv_norm_out.{parts[2]}"] = v
        elif parts[1] in ("down", "up"):
            lvl = int(parts[2])
            blk = (f"down_blocks.{lvl}" if parts[1] == "down"
                   else f"up_blocks.{n_up - 1 - lvl}")
            if parts[3] == "block":
                sub = _ldm_resnet(".".join(parts[5:]))
                out[f"{side}.{blk}.resnets.{parts[4]}.{sub}"] = v
            elif parts[3] == "downsample":
                out[f"{side}.{blk}.downsamplers.0.{'.'.join(parts[4:])}"] = v
            elif parts[3] == "upsample":
                out[f"{side}.{blk}.upsamplers.0.{'.'.join(parts[4:])}"] = v
        elif parts[1] == "mid":
            if parts[2] in ("block_1", "block_2"):
                sub = _ldm_resnet(".".join(parts[3:]))
                unit = "0" if parts[2] == "block_1" else "1"
                out[f"{side}.mid_block.resnets.{unit}.{sub}"] = v
            elif parts[2] == "attn_1":
                name, v = attn(".".join(parts[3:]), v)
                out[f"{side}.mid_block.attentions.0.{name}"] = v
    return out


def convert_single_file(sd) -> Dict[str, dict]:
    """An original-SD single-file state dict -> ``{"unet", "vae",
    "text_encoder"}`` state dicts in the port's names (the components the
    file has). EMA weights (``model_ema.*``) are ignored, as diffusers'
    loader does by default."""
    parts = {"unet": "model.diffusion_model.", "vae": "first_stage_model.",
             "text_encoder": "cond_stage_model.transformer."}
    split = {name: {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}
             for name, p in parts.items()}
    out = {}
    if split["unet"]:
        out["unet"] = ldm_unet_to_diffusers(split["unet"])
    if split["vae"]:
        out["vae"] = ldm_vae_to_diffusers(split["vae"])
    if split["text_encoder"]:
        out["text_encoder"] = convert_clip_text(split["text_encoder"])
    return out


# ---------------------------------------------------------------------------
# textual inversion
# ---------------------------------------------------------------------------


def load_textual_inversion(tokenizer, sd, token: Optional[str] = None,
                           dim: Optional[int] = None):
    """A user textual-inversion embedding: (token, rows (n, D) fp32).

    Both published layouts: ``{"<token>": (n, D)}`` (an A1111 ``.pt``'s
    ``string_to_param``, flattened) and ``{"emb_params": ...}`` /
    ``{"clip_l": ...}``. The token is registered on ``tokenizer`` with one
    placeholder per row (``<token>_0 .. <token>_{n-1}`` for n > 1), so its
    ids follow every earlier placeholder's; ``dim``, the text tower's
    width, is checked first."""
    rows = None
    for key in (token, "emb_params", "clip_l", "string_to_param"):
        if key is not None and key in sd:
            rows = sd[key]
            break
    if rows is None and len(sd) == 1:
        (token_in_file, rows), = sd.items()
        token = token or str(token_in_file)
    if rows is None:
        raise ValueError(f"no embedding tensor found (keys: {sorted(sd)})")
    if token is None:
        raise ValueError("token name required for this file layout")
    rows = torch.as_tensor(rows).float()
    rows = rows.reshape(-1, rows.shape[-1])
    if dim is not None and rows.shape[1] != dim:
        raise ValueError(f"{token}: embedding width {rows.shape[1]}, the "
                         f"text tower's is {dim}")
    tokenizer.add_placeholder_token(token, num_vec_per_token=rows.shape[0])
    return token, rows
