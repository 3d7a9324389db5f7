"""DPT-hybrid monocular depth network (the port of
``powerpaint_tpu/models/dpt.py``; Ranftl et al., "Vision Transformers for
Dense Prediction", ICCV 2021): a BiT stem (weight-standardised convs,
GroupNorm + ReLU) feeding a ViT-B encoder, DPT reassembly of four feature
stages, a RefineNet-style fusion pyramid and the three-conv depth head.

Modules and parameters carry HF ``DPTForDepthEstimation``'s names
(Intel/dpt-hybrid-midas layout), so its state dict loads as it is; that
includes the two entries the depth head never reads, ``dpt.layernorm`` and
the deepest fusion layer's ``residual_layer1``. Activations are NHWC.

- Every BiT GroupNorm (``GNAct``) is ``ops.norms.group_norm`` in fp32 at
  eps 1e-5 without SiLU, then ReLU: the ``csrc/group_norm.cu`` kernel on the
  card. The JAX package's ``GNAct`` calls the dispatcher that reaches its
  Pallas GroupNorm.
- The ViT keeps ``nn.LayerNorm`` and plain-op attention, as the JAX package
  keeps ``nn.LayerNorm`` and einsum there (no Pallas kernel).
- Weight standardisation (per output filter, biased variance, eps 1e-8) is
  applied to the kernel on every call, as HF's BiT does.
- Convs with ``"SAME"`` padding at stride 2 (the 7x7 stem, the strided
  3x3s) and the stem's 3x3/2 max-pool pad as TensorFlow does: more at the
  bottom and right (``same_pad``); the max-pool pads with -inf.
- Two bilinear flavours: the fusion and head upsamplers use
  ``align_corners=True`` (``resize_align_corners``); the position-embedding
  resize and the fusion layers' residual-size match use half-pixel centres
  with an antialiasing filter when they shrink (``resize_bilinear``), as
  ``jax.image.resize`` does.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from powerpaint_tpu_torch.core.config import DPTConfig
from powerpaint_tpu_torch.models.layers import Conv2D, GroupNorm


def same_pad(x: torch.Tensor, k: int, s: int, value: float = 0.0) -> torch.Tensor:
    """TensorFlow "SAME" padding of an NCHW tensor for a k x k window at
    stride s: the total pad max((ceil(n / s) - 1) * s + k - n, 0) per axis,
    the odd pixel at the bottom / right."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad takes the last axis first
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value) if any(pads) else x


def resize_align_corners(x: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """Bilinear resize of NHWC with align_corners=True."""
    if x.shape[1:3] == (oh, ow):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(oh, ow), mode="bilinear",
                      align_corners=True)
    return y.permute(0, 2, 3, 1)


def resize_bilinear(x: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """Bilinear resize of NHWC with half-pixel centres and, where it
    shrinks, the triangle filter widened by the scale (``jax.image.resize``
    "bilinear"; PyTorch's antialiased bilinear)."""
    if x.shape[1:3] == (oh, ow):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(oh, ow), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


class WSConv(nn.Conv2d):
    """Weight-standardised conv, no bias, TF-SAME padding, on NHWC."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__(cin, cout, k, stride=stride, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.float()
        var, mean = torch.var_mean(w, dim=(1, 2, 3), correction=0, keepdim=True)
        w = ((w - mean) * torch.rsqrt(var + 1e-8)).to(x.dtype)
        y = same_pad(x.permute(0, 3, 1, 2), self.kernel_size[0], self.stride[0])
        return F.conv2d(y, w, stride=self.stride).permute(0, 2, 3, 1)


class GNAct(GroupNorm):
    """BiT GroupNorm (eps 1e-5) in fp32, then ReLU unless ``act`` is off."""

    def __init__(self, groups: int, channels: int, act: bool = True):
        super().__init__(groups, channels, eps=1e-5)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x.float())
        return F.relu(y) if self.act else y


def make_div(value: float, divisor: int = 8) -> int:
    new_value = max(divisor, int(value + divisor / 2) // divisor * divisor)
    if new_value < 0.9 * value:
        new_value += divisor
    return new_value


class BitDownsampleConv(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, groups: int):
        super().__init__()
        self.conv = WSConv(cin, cout, 1, stride)
        self.norm = GNAct(groups, cout, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.conv(x))


class BitBottleneckLayer(nn.Module):
    """Non-preactivation bottleneck: 1x1, 3x3 (strided), 1x1 WS convs with
    GroupNorm + ReLU between, GroupNorm after the last, the residual (a
    strided 1x1 WS conv + GroupNorm on a stage's first unit), ReLU."""

    def __init__(self, cin: int, cout: int, stride: int, groups: int,
                 is_first: bool):
        super().__init__()
        mid = make_div(cout * 0.25)
        self.downsample = (BitDownsampleConv(cin, cout, stride, groups)
                           if is_first else None)
        self.conv1 = WSConv(cin, mid, 1)
        self.norm1 = GNAct(groups, mid)
        self.conv2 = WSConv(mid, mid, 3, stride)
        self.norm2 = GNAct(groups, mid)
        self.conv3 = WSConv(mid, cout, 1)
        self.norm3 = GNAct(groups, cout, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.downsample is None else self.downsample(x)
        h = self.norm1(self.conv1(x))
        h = self.norm2(self.conv2(h))
        h = self.norm3(self.conv3(h))
        return F.relu(h + shortcut)


class BitEmbeddings(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        self.convolution = WSConv(3, cfg.embedding_size, 7, 2)
        self.norm = GNAct(cfg.bit_num_groups, cfg.embedding_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm(self.convolution(x)).permute(0, 3, 1, 2)
        h = F.max_pool2d(same_pad(h, 3, 2, float("-inf")), 3, 2)
        return h.permute(0, 2, 3, 1)


class BitStage(nn.Module):
    def __init__(self, cin: int, cout: int, depth: int, stride: int, groups: int):
        super().__init__()
        self.layers = nn.ModuleList([
            BitBottleneckLayer(cin if i == 0 else cout, cout,
                               stride if i == 0 else 1, groups, i == 0)
            for i in range(depth)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


class BitEncoder(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        chans = (cfg.embedding_size,) + tuple(cfg.bit_hidden_sizes)
        self.stages = nn.ModuleList([
            BitStage(chans[i], chans[i + 1], depth, 1 if i == 0 else 2,
                     cfg.bit_num_groups)
            for i, depth in enumerate(cfg.bit_depths)])


class BitModel(nn.Module):
    """The stem and the stages; returns every stage's output (1/4, 1/8 and
    1/16 of the input)."""

    def __init__(self, cfg: DPTConfig):
        super().__init__()
        self.embedder = BitEmbeddings(cfg)
        self.encoder = BitEncoder(cfg)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        h = self.embedder(x)
        feats = []
        for stage in self.encoder.stages:
            h = stage(h)
            feats.append(h)
        return feats


class BitBackbone(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        self.bit = BitModel(cfg)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        return self.bit(x)


class DPTViTHybridEmbeddings(nn.Module):
    """The BiT backbone, a 1x1 projection of its 1/16 map to tokens, the
    class token and learned positions (resized where the token grid is not
    the config's)."""

    def __init__(self, cfg: DPTConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = BitBackbone(cfg)
        self.projection = Conv2D(cfg.bit_hidden_sizes[-1], cfg.hidden_size, 1)
        n0 = (cfg.image_size // cfg.patch_size) ** 2
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.hidden_size))
        self.position_embeddings = nn.Parameter(
            torch.zeros(1, n0 + 1, cfg.hidden_size))

    def resized_positions(self, gh: int, gw: int) -> torch.Tensor:
        pos = self.position_embeddings
        n0 = pos.shape[1] - 1
        if gh * gw == n0:
            return pos
        g0 = int(n0 ** 0.5)
        grid = resize_bilinear(pos[:, 1:].reshape(1, g0, g0, -1), gh, gw)
        return torch.cat([pos[:, :1], grid.reshape(1, gh * gw, -1)], dim=1)

    def forward(self, pixels: torch.Tensor):
        """(the BiT features (f4, f8, f16), the token sequence)."""
        feats = self.backbone(pixels)
        proj = self.projection(feats[-1])
        b, gh, gw, c = proj.shape
        tokens = proj.reshape(b, gh * gw, c)
        x = torch.cat([self.cls_token.to(tokens.dtype).expand(b, 1, c), tokens],
                      dim=1)
        return feats, x + self.resized_positions(gh, gw).to(x.dtype)


class DPTSelfAttention(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(d, d)
        self.value = nn.Linear(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        hd = d // self.heads
        q, k, v = (f(x).view(b, s, self.heads, hd)
                   for f in (self.query, self.key, self.value))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / hd ** 0.5
        probs = torch.softmax(logits.float(), dim=-1).to(v.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, d)


class _Dense(nn.Module):
    """A linear under HF's ``<name>.dense`` scope."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.dense = nn.Linear(cin, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense(x)


class DPTAttention(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.attention = DPTSelfAttention(d, heads)
        self.output = _Dense(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output(self.attention(x))


class DPTViTLayer(nn.Module):
    """Pre-LN ViT block (HF DPTViTLayer wiring), exact GELU."""

    def __init__(self, cfg: DPTConfig):
        super().__init__()
        d = cfg.hidden_size
        self.attention = DPTAttention(d, cfg.num_heads)
        self.intermediate = _Dense(d, cfg.intermediate_size)
        self.output = _Dense(cfg.intermediate_size, d)
        self.layernorm_before = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.layernorm_after = nn.LayerNorm(d, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attention(self.layernorm_before(x))
        return x + self.output(F.gelu(self.intermediate(self.layernorm_after(x))))


class DPTViTEncoder(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        self.layer = nn.ModuleList([DPTViTLayer(cfg) for _ in range(cfg.num_layers)])


class DPTModel(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = DPTViTHybridEmbeddings(cfg)
        self.encoder = DPTViTEncoder(cfg)
        # HF's final LayerNorm: in the checkpoint, unread by the depth head
        self.layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, pixels: torch.Tensor):
        """(the BiT features, the token sequences after the two
        ``vit_out_layers``)."""
        feats, x = self.embeddings(pixels)
        outs = []
        for i, layer in enumerate(self.encoder.layer):
            x = layer(x)
            if i in self.cfg.vit_out_layers:
                outs.append(x)
        return feats, outs


class _NHWCModule(nn.Module):
    """A stateless NHWC op in an ``nn.Sequential``."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)


def _up2x(x: torch.Tensor) -> torch.Tensor:
    return resize_align_corners(x, x.shape[1] * 2, x.shape[2] * 2)


class ConvTranspose2D(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` on NHWC."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class DPTReassembleLayer(nn.Module):
    def __init__(self, cfg: DPTConfig, channels: int, factor: float):
        super().__init__()
        self.projection = Conv2D(cfg.hidden_size, channels, 1)
        if factor > 1:
            k = int(factor)
            self.resize = ConvTranspose2D(channels, channels, k, stride=k)
        elif factor < 1:
            self.resize = Conv2D(channels, channels, 3,
                                 stride=int(round(1 / factor)), padding=1)
        else:
            self.resize = nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resize(self.projection(x))


class DPTReassembleStage(nn.Module):
    """Hybrid reassembly: the two BiT maps pass as they are; each token
    stage concatenates the class token to every token (readout "project"),
    projects back with GELU, goes to a map, a 1x1 conv and its resize."""

    def __init__(self, cfg: DPTConfig):
        super().__init__()
        self.layers = nn.ModuleList()
        self.readout_projects = nn.ModuleList()
        for i, factor in enumerate(cfg.reassemble_factors):
            if i <= 1:
                self.layers.append(nn.Identity())
                self.readout_projects.append(nn.Sequential(nn.Identity()))
            else:
                self.layers.append(DPTReassembleLayer(
                    cfg, cfg.neck_hidden_sizes[i], factor))
                self.readout_projects.append(nn.Sequential(
                    nn.Linear(2 * cfg.hidden_size, cfg.hidden_size), nn.GELU()))

    def forward(self, feats, tokens, gh: int, gw: int) -> List[torch.Tensor]:
        stages = list(feats[:2])
        for i, tok in enumerate(tokens, start=2):
            body = tok[:, 1:]
            h = torch.cat([body, tok[:, :1].expand_as(body)], dim=-1)
            h = self.readout_projects[i](h).reshape(h.shape[0], gh, gw, -1)
            stages.append(self.layers[i](h))
        return stages


class DPTPreActResidualLayer(nn.Module):
    """ReLU, conv, ReLU, conv, plus the input."""

    def __init__(self, c: int):
        super().__init__()
        self.convolution1 = Conv2D(c, c, 3, padding=1)
        self.convolution2 = Conv2D(c, c, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.convolution2(F.relu(self.convolution1(F.relu(x))))


class DPTFeatureFusionLayer(nn.Module):
    """Add the refined residual, refine, upsample x2 (align_corners=True),
    1x1 projection."""

    def __init__(self, c: int):
        super().__init__()
        self.projection = Conv2D(c, c, 1)
        self.residual_layer1 = DPTPreActResidualLayer(c)
        self.residual_layer2 = DPTPreActResidualLayer(c)

    def forward(self, x: torch.Tensor, residual=None) -> torch.Tensor:
        if residual is not None:
            residual = resize_bilinear(residual, x.shape[1], x.shape[2])
            x = x + self.residual_layer1(residual)
        return self.projection(_up2x(self.residual_layer2(x)))


class DPTFeatureFusionStage(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        self.layers = nn.ModuleList([
            DPTFeatureFusionLayer(cfg.fusion_hidden_size)
            for _ in cfg.neck_hidden_sizes])

    def forward(self, feats: List[torch.Tensor]) -> torch.Tensor:
        fused = None
        for layer, f in zip(self.layers, reversed(feats)):  # deepest first
            fused = layer(f) if fused is None else layer(fused, f)
        return fused


class DPTNeck(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        self.reassemble_stage = DPTReassembleStage(cfg)
        self.convs = nn.ModuleList([
            Conv2D(c, cfg.fusion_hidden_size, 3, padding=1, bias=False)
            for c in cfg.neck_hidden_sizes])
        self.fusion_stage = DPTFeatureFusionStage(cfg)

    def forward(self, feats, tokens, gh: int, gw: int) -> torch.Tensor:
        stages = self.reassemble_stage(feats, tokens, gh, gw)
        return self.fusion_stage([conv(s) for conv, s in zip(self.convs, stages)])


class DPTDepthEstimationHead(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        c = cfg.fusion_hidden_size
        self.head = nn.Sequential(
            Conv2D(c, c // 2, 3, padding=1), _NHWCModule(_up2x),
            Conv2D(c // 2, 32, 3, padding=1), nn.ReLU(),
            Conv2D(32, 1, 1), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(x)[..., 0]


class DPTDepthModel(nn.Module):
    """The hybrid DPT depth network. Input (B, H, W, 3) pixels normalised
    by the DPT preprocessing (mean 0.5, std 0.5), H and W multiples of
    ``patch_size``; output (B, H, W) inverse depth (HF ``predicted_depth``)."""

    def __init__(self, config: DPTConfig):
        super().__init__()
        self.config = config
        self.dpt = DPTModel(config)
        self.neck = DPTNeck(config)
        self.head = DPTDepthEstimationHead(config)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        feats, tokens = self.dpt(pixels)
        gh, gw = feats[-1].shape[1:3]
        return self.head(self.neck(feats, tokens, gh, gw))


def gn_shapes(cfg: DPTConfig, h: int, w: int) -> List[tuple]:
    """(S, C) of every BiT GroupNorm of one forward on an h x w input, in
    launch order: one ``ops.norms.group_norm`` each (fp32, the config's
    groups, eps 1e-5, no SiLU)."""
    def conv_out(n, s):
        return -(-n // s)  # TF-SAME

    h, w = conv_out(h, 2), conv_out(w, 2)
    shapes = [(h * w, cfg.embedding_size)]
    h, w = conv_out(h, 2), conv_out(w, 2)  # the max-pool
    for si, (depth, width) in enumerate(zip(cfg.bit_depths, cfg.bit_hidden_sizes)):
        mid = make_div(width * 0.25)
        for li in range(depth):
            stride = 2 if si > 0 and li == 0 else 1
            oh, ow = conv_out(h, stride), conv_out(w, stride)
            if li == 0:
                shapes.append((oh * ow, width))  # the downsample's norm
            shapes += [(h * w, mid), (oh * ow, mid), (oh * ow, width)]
            h, w = oh, ow
    return shapes
