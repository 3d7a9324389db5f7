"""ResNet block + spatial up/down sampling on NHWC activations (diffusers
``ResnetBlock2D`` / ``Downsample2D`` / ``Upsample2D`` parameter names)."""

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
        h = self.conv1(self.norm1(x, silu=True))
        if self.time_emb_proj is not None and temb is not None:
            t = self.time_emb_proj(F.silu(temb))
            h = h + t[:, None, None, :].to(h.dtype)
        h = self.conv2(self.norm2(h, silu=True))
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
        return self.conv(upsample_nearest_2x(x, output_size))
