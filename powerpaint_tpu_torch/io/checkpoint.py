"""Checkpoint directories and single files to pipelines (the port of
``powerpaint_tpu/io/checkpoint.py``'s loaders).

The reference's layouts:

ppt-v1 (``checkpoints/ppt-v1``)::

    unet/*.safetensors           the fine-tuned 9-channel SD-inpainting UNet
    text_encoder/*.safetensors   the fine-tuned CLIP with the task-token rows
    vae/, tokenizer/             from the SD1.5 base (``base_dir``)
    safety_checker/              optional: registered as the default checker

ppt-v2 (``checkpoints/ppt-v2``)::

    realisticVisionV60B1_v51VAE/{unet,vae,text_encoder,tokenizer}/
    PowerPaint_Brushnet/diffusion_pytorch_model.safetensors   (BrushNet)
    PowerPaint_Brushnet/pytorch_model.bin          (the task text encoder)
    ip_adapter*.safetensors | ip-adapter*.bin      optional: an IP-Adapter
    image_encoder/{config.json, *.safetensors}     optional: its CLIP tower
                                                   (here or under the base)

(or the base's four directories at the root: the flat layout), an
original-SD single file (``load_single_file``), and a diffusers ControlNet
directory (``load_controlnet``: ``config.json`` and
``diffusion_pytorch_model.safetensors`` or ``.bin``). Each directory's weights are
its first ``*.safetensors``, else ``*.bin``, else ``*.pth``.

Every loader reads each family into CPU tensors in its stored dtype and
builds the pipeline from them on ``device`` (the card unless the caller
asks for ``"cpu"``), where ``io.weights.load_models`` casts them (linear
and conv weights to ``dtype``, bf16 by default), stores conv weights
channels-last and quantises the int8 units (``int8``, as the pipelines
take it). An asymmetric VAE (``AsymmetricAutoencoderKL``: a
``decoder.condition_encoder``) sets the ppt-v1 config's VAE from its
shapes. An IP-Adapter file sets ``config.unet.ip_adapter_dim`` and
``ip_adapter_tokens`` from its projection's shape and joins the base
UNet's state (``io.convert.convert_ip_adapter``); an ``image_encoder/``
sets ``config.image_encoder`` from its ``config.json`` and shapes
(``io.convert.infer_clip_vision_config``). A native orbax directory (the
JAX package's ``save_native``) is refused with ``NotImplementedError``:
orbax and tensorstore are not on the card's host, so neither this package
nor its train CLI reads or writes one. ppt-v2 refuses an asymmetric VAE,
which only the v1 pipeline decodes.

``save_native`` writes the train CLI's final weights in the reference
layout instead (v1 as above without ``tokenizer/``; v2 in the flat layout,
its task text encoder as ``PowerPaint_Brushnet/text_encoder/``), each
family's ``*.safetensors`` with a ``config.json`` of its config: both
packages' ``load_ppt_v1`` / ``load_ppt_v2`` read it.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, Optional

import torch

from powerpaint_tpu_torch.core.config import (
    ControlNetConfig,
    PowerPaintConfig,
    UNetConfig,
    ppt_v1_config,
    ppt_v2_config,
)
from powerpaint_tpu_torch.io import convert as C
from powerpaint_tpu_torch.text.tokenizer import (
    HashTokenizer,
    TokenizerWrapper,
    add_task_tokens,
    load_tokenizer,
)


def _find_weights(*candidates: str) -> Optional[str]:
    for pattern in candidates:
        hits = sorted(glob.glob(pattern))
        if hits:
            return hits[0]
    return None


def _dir_weights_path(d: str) -> Optional[str]:
    return _find_weights(os.path.join(d, "*.safetensors"),
                         os.path.join(d, "*.bin"), os.path.join(d, "*.pth"))


def _load_dir_weights(d: str) -> Optional[Dict[str, torch.Tensor]]:
    path = _dir_weights_path(d)
    return C.load_state_dict(path) if path else None


def _sync_text_config(config: PowerPaintConfig, text_sd) -> PowerPaintConfig:
    """The vocabulary and the task rows as the loaded table has them, so
    the tokenizer's ids and the table's rows agree."""
    vocab, n_ext = C.text_table_rows(text_sd)
    return config.replace(text_encoder=config.text_encoder.replace(
        vocab_size=vocab, num_external_tokens=n_ext))


def _build_tokenizer(base_dir: str, vocab_size: int, n_ext: int):
    """CLIP BPE from ``base_dir``'s vocabulary files, else the hash
    tokenizer over the table's vocabulary; the task tokens when the table
    has task rows."""
    tokenizer = load_tokenizer(base_dir)
    if isinstance(tokenizer.base, HashTokenizer):
        tokenizer = TokenizerWrapper(HashTokenizer(vocab_size=vocab_size))
    if n_ext:
        add_task_tokens(tokenizer)
    return tokenizer


def _refuse_native(root: str) -> None:
    if (os.path.exists(os.path.join(root, "config.json"))
            and os.path.exists(os.path.join(root, "params"))):
        raise NotImplementedError(
            f"{root!r} is a native orbax checkpoint (the JAX package's "
            "save_native / train CLI output): orbax and tensorstore are not "
            "on the card's host, so the port cannot read it. The port's "
            "train CLI writes the reference layout instead (unet/, "
            "text_encoder/, vae/ safetensors; io.checkpoint.save_native)")


def save_native(path: str, config: PowerPaintConfig, params: dict) -> None:
    """Write a stack's weights (``{family: state dict}``, as trained: fp32)
    under ``path`` in the reference checkpoint layout, with the port's
    safetensors writer: ``unet/``, ``text_encoder/``, ``vae/``, and for
    ppt-v2 ``PowerPaint_Brushnet/`` (the branch) and
    ``PowerPaint_Brushnet/text_encoder/`` (its task tower); each with a
    ``config.json`` of its config. ``load_ppt_v1`` / ``load_ppt_v2`` of
    either package read it (the tiny configs need ``config=``)."""
    from powerpaint_tpu_torch.io.safetensors import save_file

    v2 = config.brushnet is not None
    text_cfg = config.text_encoder
    files = {"unet": ("unet", "diffusion_pytorch_model", config.unet),
             "vae": ("vae", "diffusion_pytorch_model", config.vae),
             "text_encoder": ("text_encoder", "model",
                              text_cfg.replace(num_external_tokens=0)
                              if v2 else text_cfg)}
    if v2:
        files["brushnet"] = ("PowerPaint_Brushnet", "diffusion_pytorch_model",
                             config.brushnet)
        files["text_encoder_brushnet"] = (
            os.path.join("PowerPaint_Brushnet", "text_encoder"), "model",
            text_cfg)
    for family, (sub, stem, cfg) in files.items():
        d = os.path.join(path, sub)
        os.makedirs(d, exist_ok=True)
        save_file(params[family], os.path.join(d, stem + ".safetensors"))
        with open(os.path.join(d, "config.json"), "w", encoding="utf-8") as f:
            f.write(cfg.to_json())


def _vae_config(config: PowerPaintConfig, vae_sd) -> PowerPaintConfig:
    """The config with an asymmetric VAE's condition tower and decoder
    shapes where ``vae_sd`` has a condition tower, else as it is."""
    spec = C.infer_condition_layers(vae_sd)
    if not spec:
        return config
    return config.replace(vae=config.vae.replace(
        asymmetric=True, condition_layers=spec,
        **C.infer_vae_decoder_config(vae_sd)))


def load_ppt_v1(root: str, *, base_dir: Optional[str] = None,
                config: Optional[PowerPaintConfig] = None,
                dtype: torch.dtype = torch.bfloat16, device="cuda",
                int8: Optional[bool] = None):
    """An ``InpaintPipeline`` from a ppt-v1 checkpoint directory.

    ``root`` holds the fine-tuned unet/ and text_encoder/; ``base_dir``
    (default ``root``) holds vae/ and tokenizer/ from the SD1.5 base.
    ``root`` may also be an original-SD single file (``load_single_file``).
    A ``safety_checker/`` directory with weights under either is registered
    as the process's checker, unless one is registered already (ppt-v1
    runs the checker by default). An asymmetric ``vae/`` gives the
    pipeline its conditional decode."""
    from powerpaint_tpu_torch.pipelines.inpaint import InpaintPipeline

    if os.path.isfile(root):
        return load_single_file(root, base_dir=base_dir, config=config,
                                dtype=dtype, device=device, int8=int8)
    _refuse_native(root)
    base_dir = base_dir or root
    config = config or ppt_v1_config()
    state = {"unet": _load_dir_weights(os.path.join(root, "unet")),
             "text_encoder": _load_dir_weights(os.path.join(root, "text_encoder")),
             "vae": _load_dir_weights(os.path.join(base_dir, "vae"))}
    missing = [n for n, sd in state.items() if sd is None]
    if missing:
        raise FileNotFoundError(
            f"checkpoint dir {root!r} missing weights for: {missing}")
    config = _vae_config(config, state["vae"])
    state["text_encoder"] = C.convert_clip_text(state["text_encoder"])
    config = _sync_text_config(config, state["text_encoder"])
    tokenizer = _build_tokenizer(base_dir, config.text_encoder.vocab_size,
                                 config.text_encoder.num_external_tokens)
    _maybe_register_safety(root, base_dir, device=device)
    return InpaintPipeline(config, state, tokenizer, dtype=dtype,
                           device=device, int8=int8)


def _maybe_register_safety(*roots: Optional[str], device="cuda") -> None:
    """Register the CLIP safety checker from the first ``safety_checker/``
    directory with weights under ``roots``, if no checker is registered."""
    from powerpaint_tpu_torch.core import safety

    if safety.get_safety_checker() is not None:
        return
    for r in roots:
        if not r:
            continue
        d = os.path.join(r, "safety_checker")
        if os.path.isdir(d) and _dir_weights_path(d):
            safety.register_safety_checker(load_safety_checker(d, device=device))
            return


def load_single_file(path: str, *, base_dir: Optional[str] = None,
                     config: Optional[PowerPaintConfig] = None,
                     dtype: torch.dtype = torch.bfloat16, device="cuda",
                     int8: Optional[bool] = None):
    """An ``InpaintPipeline`` from one original-SD checkpoint file (the
    diffusers ``FromSingleFileMixin`` surface). Its UNet takes 4 or 9
    input channels (read from ``conv_in``). A single file carries no
    vocabulary: ``base_dir`` with a ``tokenizer/`` gives CLIP BPE, else the
    hash tokenizer stands in."""
    from powerpaint_tpu_torch.pipelines.inpaint import InpaintPipeline

    config = config or ppt_v1_config()
    state = C.convert_single_file(C.load_state_dict(path))
    missing = [n for n in ("unet", "text_encoder", "vae") if n not in state]
    if missing:
        raise FileNotFoundError(
            f"single-file checkpoint {path!r} missing components: {missing}")
    cin = int(state["unet"]["conv_in.weight"].shape[1])
    if cin != config.unet.in_channels:
        config = config.replace(unet=config.unet.replace(in_channels=cin))
    config = _sync_text_config(config, state["text_encoder"])
    tokenizer = _build_tokenizer(base_dir or os.path.dirname(path) or ".",
                                 config.text_encoder.vocab_size,
                                 config.text_encoder.num_external_tokens)
    return InpaintPipeline(config, state, tokenizer, dtype=dtype,
                           device=device, int8=int8)


def load_ppt_v2(root: str, *, config: Optional[PowerPaintConfig] = None,
                dtype: torch.dtype = torch.bfloat16, device="cuda",
                int8: Optional[bool] = None):
    """A ``BrushNetPipeline`` from the ppt-v2 two-directory layout (or its
    flat form). The task rows, and so the tokenizer's task tokens, come
    from the BrushNet text encoder."""
    from powerpaint_tpu_torch.pipelines.brushnet import BrushNetPipeline

    _refuse_native(root)
    config = config or ppt_v2_config()
    base = os.path.join(root, "realisticVisionV60B1_v51VAE")
    bn_dir = os.path.join(root, "PowerPaint_Brushnet")
    if not os.path.isdir(base):
        base = root  # the flat layout
    paths = {
        "base unet": _dir_weights_path(os.path.join(base, "unet")),
        "vae": _dir_weights_path(os.path.join(base, "vae")),
        "base text_encoder": _dir_weights_path(os.path.join(base, "text_encoder")),
        "brushnet": _find_weights(
            os.path.join(bn_dir, "diffusion_pytorch_model*.safetensors"),
            os.path.join(bn_dir, "*.safetensors")),
        "brushnet text_encoder": _find_weights(
            os.path.join(bn_dir, "pytorch_model*.bin"),
            os.path.join(bn_dir, "text_encoder", "*.safetensors"),
            os.path.join(bn_dir, "text_encoder", "*.bin")),
    }
    missing = [n for n, p in paths.items() if p is None]
    if missing:
        raise FileNotFoundError(
            f"checkpoint dir {root!r} missing weights for: {missing}")
    state = {"unet": C.load_state_dict(paths["base unet"]),
             "vae": C.load_state_dict(paths["vae"]),
             "text_encoder": C.convert_clip_text(
                 C.load_state_dict(paths["base text_encoder"])),
             "brushnet": C.load_state_dict(paths["brushnet"]),
             "text_encoder_brushnet": C.convert_clip_text(
                 C.load_state_dict(paths["brushnet text_encoder"]))}
    if C.infer_condition_layers(state["vae"]):
        raise NotImplementedError(
            "an asymmetric VAE (AsymmetricAutoencoderKL, a "
            "decoder.condition_encoder) decodes on ppt-v1 only; ppt-v2's "
            "pipeline decodes with the plain VAE, as the JAX package's does")
    config = _sync_text_config(config, state["text_encoder_brushnet"])
    config = _load_ip_adapter(root, base, config, state)
    tokenizer = _build_tokenizer(base, config.text_encoder.vocab_size,
                                 config.text_encoder.num_external_tokens)
    return BrushNetPipeline(config, state, tokenizer, dtype=dtype,
                            device=device, int8=int8)


def _load_ip_adapter(root: str, base: str, config: PowerPaintConfig,
                     state: dict) -> PowerPaintConfig:
    """The v2 directory's optional IP-Adapter, as the JAX loader finds it:
    the first ``ip_adapter*`` / ``ip-adapter*`` ``.safetensors`` / ``.bin``
    at the root (its projection's shape gives ``ip_adapter_dim`` and the
    tokens), merged into ``state["unet"]``; and ``image_encoder/`` at the
    root, else under the base, as ``state["image_encoder"]`` with its
    config from its ``config.json`` where it has one. Returns the config
    that describes them."""
    ip_path = _find_weights(*(os.path.join(root, f"{stem}*.{ext}")
                              for stem in ("ip_adapter", "ip-adapter")
                              for ext in ("safetensors", "bin")))
    if ip_path:
        ip_sd = C.load_state_dict(ip_path)
        dim, rows = C.ip_adapter_shape(ip_sd)
        tokens, rest = divmod(rows, config.unet.cross_attention_dim)
        if rest or not tokens:
            raise ValueError(
                f"{ip_path!r}: a projection of {rows} rows is no whole number "
                f"of {config.unet.cross_attention_dim}-wide tokens")
        config = config.replace(unet=config.unet.replace(
            ip_adapter_dim=dim, ip_adapter_tokens=tokens))
        state["unet"] = C.merge_ip_adapter(
            state["unet"], C.convert_ip_adapter(ip_sd, config.unet))
    for d in (os.path.join(root, "image_encoder"),
              os.path.join(base, "image_encoder")):
        path = _dir_weights_path(d)
        if path is None:
            continue
        sd = C.convert_clip_vision(C.load_state_dict(path))
        config_json = None
        if os.path.isfile(os.path.join(d, "config.json")):
            with open(os.path.join(d, "config.json"), encoding="utf-8") as f:
                config_json = json.load(f)
        state["image_encoder"] = sd
        return config.replace(
            image_encoder=C.infer_clip_vision_config(sd, config_json))
    return config


def load_safety_checker(d: str, *, device="cuda"):
    """A registrable ``CLIPSafetyChecker`` (fp32) from a diffusers
    ``safety_checker/`` directory, its config read from the shapes."""
    from powerpaint_tpu_torch.core.safety import CLIPSafetyChecker

    sd = _load_dir_weights(d)
    if sd is None:
        raise FileNotFoundError(f"no safety-checker weights under {d!r}")
    return CLIPSafetyChecker(C.infer_clip_vision_config(sd), state=sd,
                             device=device)


def controlnet_config_from_dict(d: dict) -> ControlNetConfig:
    """A ``ControlNetConfig`` from a diffusers ControlNet ``config.json``
    (the UNet's keys flat beside the conditioning embedding's) or from the
    package's own nested form (a ``base`` entry)."""
    d = {k: v for k, v in d.items() if v is not None}
    if not isinstance(d.get("base"), dict):
        d["base"] = UNetConfig.from_dict(d)
    return ControlNetConfig.from_dict(d)


def load_controlnet(path: str, *, dtype: torch.dtype = torch.bfloat16,
                    device="cuda", int8: Optional[bool] = None):
    """A ``ControlNetModel`` (its config as ``.config``) from a diffusers
    ControlNet directory: ``config.json`` and
    ``diffusion_pytorch_model.safetensors`` (else ``.bin``). The names are
    diffusers', as the port's; the weights go through the pipelines' cast
    (linear and conv weights to ``dtype``, conv weights channels-last) on
    ``device`` (the card unless ``"cpu"`` is asked for), and ``int8`` (as
    the pipelines take it) quantises the ResNet units. Give the branch to
    ``pipelines.controlnet.ControlNetPipeline.from_pipeline``."""
    from powerpaint_tpu_torch.io.weights import _load
    from powerpaint_tpu_torch.models.controlnet import ControlNetModel
    from powerpaint_tpu_torch.pipelines.common import int8_x_scale

    config_path = os.path.join(path, "config.json")
    weights = _find_weights(
        os.path.join(path, "diffusion_pytorch_model*.safetensors"),
        os.path.join(path, "diffusion_pytorch_model*.bin"))
    if weights is None:
        raise FileNotFoundError(
            f"controlnet dir {path!r} missing weights for: ['controlnet']")
    if not os.path.isfile(config_path):
        raise FileNotFoundError(
            f"controlnet dir {path!r} missing config.json for: ['controlnet']")
    with open(config_path, encoding="utf-8") as f:
        config = controlnet_config_from_dict(json.load(f))
    with torch.device("meta"):
        model = ControlNetModel(config)
    return _load(model, C.load_state_dict(weights), torch.device(device),
                 dtype, int8_x_scale(int8))
