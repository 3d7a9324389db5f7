"""ResNet block + spatial up/down sampling on NHWC activations (diffusers
``ResnetBlock2D`` / ``Downsample2D`` / ``Upsample2D`` parameter names).

Each GroupNorm + SiLU -> conv3x3 pair of a ResNet unit runs as one fused
implicit-GEMM kernel (``ops.conv.conv3x3_gn_silu``), and the upsampler's
3x3 conv as the same kernel without the prologue (``ops.conv.conv3x3``);
strided and 1x1 convs stay on cuDNN."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from powerpaint_tpu_torch.models.layers import (
    Conv2D,
    GroupNorm,
    upsample_nearest_2x,
)
from powerpaint_tpu_torch.ops.conv import conv3x3


class ResnetBlock2D(nn.Module):
    """GroupNorm+SiLU -> conv3x3 (+ time embedding) -> GroupNorm+SiLU ->
    conv3x3, plus a 1x1 shortcut when the width changes."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: Optional[int], eps: float = 1e-5,
                 groups: int = 32):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_channels, eps)
        self.conv1 = Conv2D(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = (nn.Linear(temb_channels, out_channels)
                              if temb_channels else None)
        self.norm2 = GroupNorm(groups, out_channels, eps)
        self.conv2 = Conv2D(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (Conv2D(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor,
                temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(x, gn=self.norm1)
        if self.time_emb_proj is not None and temb is not None:
            t = self.time_emb_proj(F.silu(temb))
            h = h + t[:, None, None, :].to(h.dtype)
        h = self.conv2(h, gn=self.norm2)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample2D(nn.Module):
    """Stride-2 3x3 conv with padding 1 on every side (the UNet's)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2D(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample2D(nn.Module):
    """2x nearest-neighbour upsample + 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2D(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor,
                output_size: Optional[tuple] = None) -> torch.Tensor:
        x = upsample_nearest_2x(x, output_size).contiguous()
        return conv3x3(x, self.conv.kernel_weight(), self.conv.bias)
