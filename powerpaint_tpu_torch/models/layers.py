"""Shared low-level layers on NHWC activations.

Activations are (B, H, W, C) tensors as in the JAX package. A convolution
hands cuDNN the NCHW view of that memory, which is NCHW in channels_last
format, so no copy is made on either side. A 3x3 convolution handed a
GroupNorm (``Conv2D(x, gn=norm)``, the ResNet unit) runs instead as the
hand-written implicit-GEMM kernel of ``ops.conv`` with GroupNorm + SiLU as
its prologue (with int8 on, as the static-scale int8 kernel
``ops.conv.conv3x3_gn_silu_int8`` where the JAX package quantises).
Parameters use the diffusers names and layouts (conv ``weight`` OIHW,
linear ``weight`` (out, in), norm ``weight``/``bias``), so a diffusers state
dict loads as it is.

Norm parameters stay fp32 while linear and conv weights take the compute
dtype (``cast_compute``), the JAX package's bf16-compute / fp32-statistics
policy.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from powerpaint_tpu_torch.ops.conv import (
    conv3x3_gn_silu,
    conv3x3_gn_silu_int8,
    int8_site,
)
from powerpaint_tpu_torch.ops.norms import group_norm, layer_norm


class GroupNorm(nn.Module):
    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor, silu: bool = False) -> torch.Tensor:
        return group_norm(x.contiguous(), self.weight, self.bias,
                          num_groups=self.num_groups, eps=self.eps, silu=silu)


class LayerNorm(nn.Module):
    def __init__(self, num_channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x.contiguous(), self.weight, self.bias, eps=self.eps)


class Conv2D(nn.Conv2d):
    """``nn.Conv2d`` applied to an NHWC tensor; returns NHWC.

    ``gn``, a ``GroupNorm``, prepends GroupNorm + SiLU to a 3x3 stride-1
    SAME conv, and the pair runs as ``ops.conv.conv3x3_gn_silu``; the
    parameters stay where they are, so state-dict keys do not change.
    After ``set_int8`` the pair runs as ``ops.conv.conv3x3_gn_silu_int8``
    wherever ``ops.conv.int8_site`` admits the call's shape."""

    int8_x_scale: Optional[float] = None

    def forward(self, x: torch.Tensor,
                gn: Optional[GroupNorm] = None) -> torch.Tensor:
        if gn is None:
            return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        if self.kernel_size != (3, 3) or self.stride != (1, 1) or \
                self.padding != (1, 1):
            raise ValueError("a GroupNorm prologue needs a 3x3 stride-1 SAME conv")
        _, h, w, cin = x.shape
        if self.int8_x_scale is not None and int8_site(h, w, cin,
                                                       self.out_channels):
            return conv3x3_gn_silu_int8(
                x.contiguous(), self.w_q, self.w_scale, self.bias_fp32,
                gn.weight, gn.bias, x_scale=self.int8_x_scale,
                num_groups=gn.num_groups, eps=gn.eps)
        return conv3x3_gn_silu(x.contiguous(), self.kernel_weight(), self.bias,
                               gn.weight, gn.bias, num_groups=gn.num_groups,
                               eps=gn.eps)

    def set_int8(self, w_q: torch.Tensor, w_scale: torch.Tensor,
                 bias: Optional[torch.Tensor], x_scale: float) -> None:
        """Turn on the int8 W8A8 form of the GroupNorm prologue: ``w_q`` /
        ``w_scale`` from ``ops.conv.quantize_weights_int8``, the fp32 bias
        and the static activation scale. They are non-persistent buffers:
        the state dict keeps its keys."""
        self.register_buffer("w_q", w_q, persistent=False)
        self.register_buffer("w_scale", w_scale, persistent=False)
        self.register_buffer("bias_fp32", bias, persistent=False)
        self.int8_x_scale = float(x_scale)

    def kernel_weight(self) -> torch.Tensor:
        """The weight in channels-last memory, (Cout, 3, 3, Cin) contiguous:
        the layout ``ops.conv`` reads. ``io.weights.load_models`` stores it
        so, and then this is the weight itself; otherwise a copy made once
        and kept, outside the state dict, until the weight changes."""
        w = self.weight
        if w.is_contiguous(memory_format=torch.channels_last):
            return w
        key = (w.data_ptr(), w._version, w.dtype, w.device)
        if getattr(self, "_packed_key", None) != key:
            self._packed = w.detach().contiguous(memory_format=torch.channels_last)
            self._packed_key = key
        return self._packed


def cast_compute(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Linear and conv parameters to ``dtype``, every other parameter (norms,
    embedding tables) to fp32, in place."""
    for m in model.modules():
        target = dtype if isinstance(m, (nn.Linear, nn.Conv2d)) else torch.float32
        for p in m.parameters(recurse=False):
            if p.dtype != target:
                p.data = p.data.to(target)
    return model


def timestep_sinusoid(timesteps: torch.Tensor, dim: int, *,
                      flip_sin_to_cos: bool = True,
                      downscale_freq_shift: float = 0.0,
                      max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep features (diffusers ``Timesteps``), fp32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    out = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        out = F.pad(out, (0, 1))
    return out


class TimestepEmbedding(nn.Module):
    """linear -> silu -> linear (diffusers TimestepEmbedding)."""

    def __init__(self, in_channels: int, embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_channels, embed_dim)
        self.linear_2 = nn.Linear(embed_dim, embed_dim)

    def forward(self, sample: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(sample)))


def upsample_nearest_2x(x: torch.Tensor,
                        output_size: Optional[tuple] = None) -> torch.Tensor:
    """Nearest upsampling of NHWC to twice the size, or to ``output_size``
    with half-pixel centres (``jax.image.resize`` "nearest")."""
    b, h, w, c = x.shape
    y = x.permute(0, 3, 1, 2)
    if output_size is None or tuple(output_size) == (2 * h, 2 * w):
        y = F.interpolate(y, scale_factor=2.0, mode="nearest")
    else:
        y = F.interpolate(y, size=tuple(output_size), mode="nearest-exact")
    return y.permute(0, 2, 3, 1)
