"""LoRA checkpoints merged into the pipelines' weights, and textual
inversion (the port of ``powerpaint_tpu/io/lora.py``).

A LoRA adds ``scale * (alpha / rank) * up @ down`` to a linear weight
(O, I), or ``up`` (O, r, 1, 1) times ``down`` (r, I, kh, kw) to a conv
weight (OIHW, a LoCon), merged once on the device so a call runs no extra
product. Only the ``unet`` and ``text_encoder`` targets are touched (on
ppt-v2 that text encoder is the base UNet's plain tower), as in the JAX
package.

Key formats (those diffusers' loader accepts): peft / diffusers
(``unet.<module>.lora_A.weight`` / ``lora_B.weight`` / ``.alpha``), the old
attn-processor form (``<module>.processor.to_q_lora.down.weight``) and
kohya / A1111 (``lora_unet_<module_with_underscores>.lora_down.weight`` /
``lora_up.weight`` / ``alpha``). Module paths resolve as the JAX package
resolves them against its parameter tree: each target's parameter names
are mapped to the JAX tree's paths (``resnets.0`` -> ``resnets_0``,
``transformer_blocks.k`` -> ``blocks_k``, ``to_out.0`` -> ``to_out``,
``ff.net.0.proj`` / ``ff.net.2`` -> ``ff.proj_in`` / ``ff.proj_out``, the
CLIP prefixes and ``mlp`` dropped), and a kohya name is matched token by
token against that tree, longest child first, so one file matches the same
modules in both packages and leaves the same ones unmatched.

The merge updates each weight in place (``add_``), keeping its storage and
its channels-last strides, and quantises a touched int8 conv again from the
merged weight (the JAX package quantises from the current weights inside
its program). On a tensor-parallel model (``parallel.mesh.shard_model``) a
delta is matched against the whole weight's shape and cut as the weight is
(``local_piece``: GEGLU's interleave included), so each rank adds its piece
of the one-process merge.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from powerpaint_tpu_torch.core.validation import InputValidationError
from powerpaint_tpu_torch.ops.conv import quantize_weights_int8
from powerpaint_tpu_torch.parallel.mesh import local_piece, whole_shape

__all__ = ["parse_lora", "resolve_module", "lora_delta", "merge_lora",
           "LoraMixin"]

TARGETS = ("unet", "text_encoder")

_SUFFIXES = (
    (".lora_A.weight", "down"),
    (".lora_B.weight", "up"),
    (".lora_down.weight", "down"),
    (".lora_up.weight", "up"),
    (".lora.down.weight", "down"),
    (".lora.up.weight", "up"),
    (".down.weight", "down"),   # old attn-processor ...to_q_lora.down.weight
    (".up.weight", "up"),
    (".alpha", "alpha"),
)


def parse_lora(sd) -> Dict[Tuple[str, str], dict]:
    """Group a LoRA state dict's keys into per-module records
    ``{(target, base): {"down", "up", "alpha"}}``: ``target`` "unet",
    "text_encoder" or "text_encoder_2", ``base`` the module path as the
    file spells it (dotted or kohya-underscored). Records without both
    factors are dropped."""
    out: Dict[Tuple[str, str], dict] = {}
    for key, val in sd.items():
        for suffix, kind in _SUFFIXES:
            if key.endswith(suffix):
                base = key[: -len(suffix)]
                break
        else:
            continue
        # the old attn-processor spelling: <mod>.processor.to_q_lora -> to_q
        base = re.sub(r"\.processor\.to_out_lora$", ".to_out.0", base)
        base = re.sub(r"\.processor\.to_(q|k|v)_lora$", r".to_\1", base)
        base = re.sub(r"_lora$", "", base)
        for prefix, target in (("lora_unet_", "unet"),
                               ("lora_te2_", "text_encoder_2"),
                               ("lora_te1_", "text_encoder"),
                               ("lora_te_", "text_encoder"),
                               ("unet.", "unet"),
                               ("text_encoder_2.", "text_encoder_2"),
                               ("text_encoder.", "text_encoder")):
            if base.startswith(prefix):
                base = base[len(prefix):]
                break
        else:
            target = "unet"  # a bare module path is a UNet LoRA
        rec = out.setdefault((target, base),
                             {"down": None, "up": None, "alpha": None})
        val = torch.as_tensor(val)
        if kind == "alpha":
            rec["alpha"] = float(val.reshape(()))
        else:
            rec[kind] = val
    return {k: v for k, v in out.items()
            if v["down"] is not None and v["up"] is not None}


# ---------------------------------------------------------------------------
# module paths
# ---------------------------------------------------------------------------

_NORM_HINTS = ("norm", "layer_norm", "final_layer_norm", "conv_norm_out",
               "group_norm")


def _jax_path(key: str) -> Tuple[str, ...]:
    """A diffusers / transformers parameter name -> the JAX package's tree
    path of it (its ``torch_key_to_flax_path``)."""
    k = key
    for old, new in (("text_model.embeddings.", ""),
                     ("text_model.encoder.", ""), ("text_model.", ""),
                     ("token_embedding.wrapped.", "token_embedding."),
                     ("ff.net.0.proj", "ff.proj_in"), ("ff.net.2", "ff.proj_out"),
                     ("to_out.0", "to_out"), ("transformer_blocks.", "blocks."),
                     (".mlp.", ".")):
        k = k.replace(old, new)
    parts = k.split(".")
    out: List[str] = []
    i = 0
    while i < len(parts):
        if i + 1 < len(parts) and parts[i + 1].isdigit():
            out.append(f"{parts[i]}_{parts[i + 1]}")
            i += 2
        else:
            out.append(parts[i])
            i += 1
    if out[-1] == "weight":
        parent = out[-2] if len(out) >= 2 else ""
        out[-1] = ("scale" if any(h in parent for h in _NORM_HINTS)
                   else "kernel")
    return tuple(out)


def module_tree(model: nn.Module) -> dict:
    """The JAX package's parameter tree of ``model``'s family, its leaves
    the port's parameter names. A CLIP tower's token and position tables
    are leaves there, and its task rows one ``external_embedding`` leaf."""
    tree: dict = {}
    for name, _ in model.named_parameters():
        if ".trainable_embeddings." in name:
            tree["external_embedding"] = name
            continue
        path = _jax_path(name)
        if path[0] in ("token_embedding", "position_embedding"):
            tree[path[0]] = name
            continue
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = name
    return tree


def _resolve_dotted(tree: dict, dotted: str) -> Optional[Tuple[str, ...]]:
    path = _jax_path(dotted + ".weight")[:-1]
    node = tree
    for p in path:
        if not isinstance(node, dict) or p not in node:
            return None
        node = node[p]
    return path


def _resolve_kohya(tree: dict, name: str) -> Optional[Tuple[str, ...]]:
    """A kohya underscore-joined module path, matched token by token
    against ``tree`` (the longest child key first), with the renames as
    aliases (``transformer_blocks_k`` for ``blocks_k``, ``to_out_0`` for
    ``to_out``, ``ff_net_0_proj`` / ``ff_net_2`` for ``ff.proj_in`` /
    ``ff.proj_out``) and the CLIP ``text_model`` / ``encoder`` prefixes
    skipped where the tree has no such child."""
    tokens = name.split("_")

    def child_aliases(key: str):
        out = [(tuple(key.split("_")), (key,))]
        m = re.fullmatch(r"blocks_(\d+)", key)
        if m:
            out.append((("transformer", "blocks", m.group(1)), (key,)))
        if key == "to_out":
            out.append((("to", "out", "0"), (key,)))
        if key == "ff":
            out.append((("ff", "net", "0", "proj"), ("ff", "proj_in")))
            out.append((("ff", "net", "2"), ("ff", "proj_out")))
        return out

    def rec(node, toks) -> Optional[Tuple[str, ...]]:
        if not toks:
            return () if isinstance(node, dict) else None
        if not isinstance(node, dict):
            return None
        for skip in (("text", "model"), ("encoder",)):
            if tuple(toks[: len(skip)]) == skip and toks[len(skip):]:
                got = rec(node, toks[len(skip):])
                if got is not None:
                    return got
        cands = []
        for key in node:
            for consume, descend in child_aliases(key):
                if tuple(toks[: len(consume)]) == consume:
                    cands.append((len(consume), consume, descend))
        cands.sort(key=lambda c: -c[0])
        for _, consume, descend in cands:
            sub = node
            for d in descend:
                if not isinstance(sub, dict) or d not in sub:
                    sub = None
                    break
                sub = sub[d]
            if sub is None:
                continue
            got = rec(sub, toks[len(consume):])
            if got is not None:
                return tuple(descend) + got
        return None

    return rec(tree, tokens)


def resolve_module(tree: dict, base: str) -> Optional[Tuple[str, ...]]:
    """``base`` (dotted or kohya) -> its path in ``module_tree``'s tree."""
    got = _resolve_dotted(tree, base)
    if got is not None or "." in base:
        return got
    return _resolve_kohya(tree, base)


# ---------------------------------------------------------------------------
# the delta and the merge
# ---------------------------------------------------------------------------


def _delta_shape(rec: dict) -> Tuple[int, ...]:
    down, up = rec["down"], rec["up"]
    if down.ndim not in (2, 4):
        raise ValueError(f"unsupported LoRA tensor rank {down.ndim}")
    return (int(up.shape[0]),) + tuple(int(s) for s in down.shape[1:])


def lora_delta(rec: dict, weight: torch.Tensor, scale: float) -> torch.Tensor:
    """``scale * (alpha / rank) * up @ down`` for ``weight`` (a linear's
    (O, I) or a conv's OIHW, ``_delta_shape(rec)``), in fp32 on its
    device."""
    down = rec["down"].to(weight.device, torch.float32)
    up = rec["up"].to(weight.device, torch.float32)
    rank = down.shape[0]
    alpha = rec["alpha"] if rec["alpha"] is not None else float(rank)
    s = scale * alpha / rank
    if down.ndim == 2:
        return (up @ down) * s
    return torch.einsum("or,rikl->oikl", up[:, :, 0, 0], down) * s


class _Plan:
    """A parsed LoRA resolved against the pipeline's modules: (record, the
    module whose weight it changes) pairs, and the unmatched modules."""

    def __init__(self, models: Dict[str, nn.Module], sd, strict: bool):
        records = parse_lora(sd)
        if not records:
            raise ValueError("no LoRA A/B pairs found in state dict")
        trees = {t: module_tree(m) for t, m in models.items()}
        self.items: List[Tuple[dict, nn.Module]] = []
        self.unmatched: List[str] = []
        for (target, base), rec in records.items():
            tree = trees.get(target)
            if tree is None:
                self.unmatched.append(f"{target}:{base} (no such target)")
                continue
            path = resolve_module(tree, base)
            if path is None:
                self.unmatched.append(f"{target}:{base}")
                continue
            node = tree
            for p in path:
                node = node[p]
            if not isinstance(node, dict) or "kernel" not in node:
                self.unmatched.append(f"{target}:{base} (no weight at "
                                      f"{'.'.join(path)})")
                continue
            module = models[target].get_submodule(
                node["kernel"][: -len(".weight")])
            if whole_shape(module) != _delta_shape(rec):
                raise ValueError(
                    f"{target}:{base}: LoRA delta shape {_delta_shape(rec)} "
                    f"!= weight {whole_shape(module)}")
            self.items.append((rec, module))
        if strict and self.unmatched:
            raise ValueError(f"unmatched LoRA modules: {self.unmatched}")

    def tensors(self) -> List[torch.Tensor]:
        """Every tensor a merge changes: the weights, and the int8 weights
        and scales of the quantised convs among them."""
        out = []
        for _, m in self.items:
            out.append(m.weight)
            if getattr(m, "int8_x_scale", None) is not None:
                out += [m.w_q, m.w_scale]
        return out

    @torch.no_grad()
    def merge(self, scale: float) -> None:
        for rec, m in self.items:
            delta = local_piece(m, lora_delta(rec, m.weight, scale))
            m.weight.add_(delta.to(m.weight.dtype))
            if getattr(m, "int8_x_scale", None) is not None:
                w_q, w_scale = quantize_weights_int8(m.weight)
                m.w_q.copy_(w_q)
                m.w_scale.copy_(w_scale)


def merge_lora(models: Dict[str, nn.Module], sd, scale: float = 1.0, *,
               strict: bool = False) -> List[str]:
    """Merge a LoRA state dict into ``models`` (``{"unet": ...,
    "text_encoder": ...}``) in place; returns the unmatched module paths
    (``strict``: raise instead). Merging with ``-scale`` unmerges, exact to
    the rounding of the weights' dtype."""
    plan = _Plan(models, sd, strict)
    plan.merge(scale)
    return plan.unmatched


class LoraMixin:
    """The pipelines' LoRA and textual-inversion surface (diffusers'
    ``LoraLoaderMixin`` / ``TextualInversionLoaderMixin``): merges into the
    ``unet`` and ``text_encoder`` modules and remembers each LoRA, so its
    scale can change or it can be unloaded."""

    def _lora_models(self) -> Dict[str, nn.Module]:
        return {t: getattr(self, t) for t in TARGETS}

    def load_lora_weights(self, sd_or_path, scale: float = 1.0,
                          strict: bool = False) -> List[str]:
        """Merge a LoRA (a state dict or a file) at ``scale``; returns the
        module paths that matched nothing."""
        from powerpaint_tpu_torch.io.convert import load_state_dict

        sd = (load_state_dict(sd_or_path) if isinstance(sd_or_path, str)
              else sd_or_path)
        plan = _Plan(self._lora_models(), sd, strict)
        plan.merge(scale)
        if not hasattr(self, "_loaded_loras"):
            self._loaded_loras = []
        self._loaded_loras.append([plan, scale])
        return plan.unmatched

    def set_lora_scale(self, scale: float) -> None:
        """Merge the most recent LoRA again at ``scale`` (the difference
        of the two is added: exact to the rounding of the weights' dtype)."""
        if not getattr(self, "_loaded_loras", None):
            raise RuntimeError("no LoRA loaded")
        entry = self._loaded_loras[-1]
        entry[0].merge(scale - entry[1])
        entry[1] = scale

    def _with_lora_scale(self, cross_attention_kwargs: dict, fn):
        """Run ``fn`` with the most recent LoRA at the per-call scale
        ``cross_attention_kwargs["scale"]`` (the only key meaningful on
        merged weights), then put back every tensor the merge changed, bit
        for bit, from copies taken before it. A scale equal to the current
        one merges nothing."""
        unknown = set(cross_attention_kwargs) - {"scale"}
        if unknown:
            raise InputValidationError(
                f"unsupported cross_attention_kwargs keys: {sorted(unknown)}"
                " (only 'scale' — the per-call LoRA scale — is meaningful"
                " on merged-weight trees)")
        scale = float(cross_attention_kwargs["scale"])
        if not getattr(self, "_loaded_loras", None):
            raise InputValidationError(
                "cross_attention_kwargs['scale'] requires a loaded LoRA "
                "(load_lora_weights)")
        entry = self._loaded_loras[-1]
        if scale == entry[1]:
            return fn()
        tensors = entry[0].tensors()
        saved = [t.detach().clone() for t in tensors]
        old = entry[1]
        self.set_lora_scale(scale)
        try:
            return fn()
        finally:
            with torch.no_grad():
                for t, s in zip(tensors, saved):
                    t.copy_(s)
            entry[1] = old

    def unload_lora_weights(self) -> None:
        """Unmerge every loaded LoRA, the last first: exact in fp32, within
        the rounding of the weights' dtype otherwise."""
        for plan, scale in reversed(getattr(self, "_loaded_loras", [])):
            plan.merge(-scale)
        self._loaded_loras = []

    def add_textual_inversion(self, sd_or_path,
                              token: Optional[str] = None) -> None:
        """Register a user textual-inversion embedding: its placeholder on
        the tokenizer and its rows appended to the task-token tower's table
        (``text_encoder_brushnet`` on ppt-v2, else ``text_encoder``), after
        every row before them."""
        from powerpaint_tpu_torch.io.convert import (
            load_state_dict,
            load_textual_inversion,
        )

        sd = (load_state_dict(sd_or_path) if isinstance(sd_or_path, str)
              else sd_or_path)
        tower = getattr(self, "text_encoder_brushnet", None) or self.text_encoder
        token, rows = load_textual_inversion(
            self.tokenizer, sd, token=token, dim=tower.config.hidden_size)
        tower.add_token_rows(token, rows)
