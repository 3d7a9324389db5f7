"""The T2I-Adapter (Mou et al. 2023, arXiv 2302.08453), SD1.5 "full
adapter", on NHWC activations: the port of
``powerpaint_tpu/models/adapter.py`` with diffusers ``T2IAdapter``
parameter names (``adapter.conv_in``, ``adapter.body.<i>.in_conv``,
``adapter.body.<i>.resnets.<j>.block1`` / ``block2``), so a diffusers
state dict loads as it is.

A conditioning image is pixel-unshuffled onto the latent grid and pushed
through a small conv pyramid that gives one feature per UNet down block
(64², 32², 16², 8² at 512²), which
``UNet2DConditionModel(..., down_intrablock_additional_residuals=...)``
takes. No pipeline of the JAX package takes an adapter: this is a
UNet-level path. Its convs run on cuDNN (the JAX package leaves them to
XLA, outside any Pallas kernel).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from powerpaint_tpu_torch.models.layers import Conv2D


def pixel_unshuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """torch ``PixelUnshuffle(r)`` on an NHWC tensor: out[b, h, w, c*r*r +
    i*r + j] = x[b, r*h + i, r*w + j, c], the channel order (c, i, j) of
    the NCHW op, which the conv weights after it expect."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // r, r, w // r, r, c)
    x = x.permute(0, 1, 3, 5, 2, 4)  # (b, h/r, w/r, c, i, j)
    return x.reshape(b, h // r, w // r, c * r * r)


class AdapterResnetBlock(nn.Module):
    """conv3x3 -> ReLU -> conv1x1, plus the residual."""

    def __init__(self, channels: int):
        super().__init__()
        self.block1 = Conv2D(channels, channels, 3, padding=1)
        self.block2 = Conv2D(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.block2(F.relu(self.block1(x)))


class AdapterBlock(nn.Module):
    """A 2x2 average pool (``down``), a 1x1 ``in_conv`` where the width
    changes, then ``num_res_blocks`` residual units."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_res_blocks: int, down: bool = False):
        super().__init__()
        self.down = down
        self.in_conv = (Conv2D(in_channels, out_channels, 1)
                        if in_channels != out_channels else None)
        self.resnets = nn.ModuleList([AdapterResnetBlock(out_channels)
                                      for _ in range(num_res_blocks)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.down:  # floor, as flax's VALID avg_pool (even maps alike)
            x = F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        if self.in_conv is not None:
            x = self.in_conv(x)
        for resnet in self.resnets:
            x = resnet(x)
        return x


class FullAdapter(nn.Module):
    def __init__(self, channels: Sequence[int], num_res_blocks: int,
                 downscale_factor: int, in_channels: int):
        super().__init__()
        self.downscale_factor = downscale_factor
        self.conv_in = Conv2D(in_channels * downscale_factor ** 2, channels[0],
                              3, padding=1)
        self.body = nn.ModuleList([
            AdapterBlock(channels[max(i - 1, 0)], ch, num_res_blocks,
                         down=i > 0)
            for i, ch in enumerate(channels)])

    def forward(self, cond: torch.Tensor) -> List[torch.Tensor]:
        x = pixel_unshuffle(cond.to(self.conv_in.weight.dtype),
                            self.downscale_factor)
        x = self.conv_in(x)
        feats = []
        for block in self.body:
            x = block(x)
            feats.append(x)
        return feats


class T2IAdapter(nn.Module):
    """``T2IAdapter()(cond)``: cond (B, H, W, in_channels) in [0, 1], H and
    W multiples of ``downscale_factor`` * 2^(levels - 1), -> one NHWC
    feature per entry of ``channels``, at H/8, H/16, H/32, H/64 with the
    defaults: the SD1.5 UNet's down-block grid and widths."""

    def __init__(self, channels: Sequence[int] = (320, 640, 1280, 1280),
                 num_res_blocks: int = 2, downscale_factor: int = 8,
                 in_channels: int = 3):
        super().__init__()
        self.adapter = FullAdapter(tuple(channels), num_res_blocks,
                                   downscale_factor, in_channels)

    def forward(self, cond: torch.Tensor) -> List[torch.Tensor]:
        return self.adapter(cond)
