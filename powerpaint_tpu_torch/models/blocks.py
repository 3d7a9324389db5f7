"""UNet down / mid / up blocks on NHWC activations (diffusers
``CrossAttnDownBlock2D`` / ``DownBlock2D`` / ``UNetMidBlock2DCrossAttn`` /
``CrossAttnUpBlock2D`` / ``UpBlock2D`` parameter names). One class per
direction: a block with ``cross_attention`` has the ``attentions`` list,
otherwise it is the plain resnet block.

BrushNet taps (ppt-v2) arrive as ``add_samples``, consumed in order, as in
the JAX package: a down block adds one after each (resnet, attention) pair
and one after the downsampler, each BEFORE the skip is recorded; an up
block adds one after each pair and after the upsampler, and with ``emit``
records each feature BEFORE its tap is added (the BrushNet branch's
outputs)."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from powerpaint_tpu_torch.models.resnet import (
    Downsample2D,
    ResnetBlock2D,
    Upsample2D,
)
from powerpaint_tpu_torch.models.transformer import Transformer2DModel


def _attentions(cross_attention: bool, n: int, channels: int, num_heads: int,
                context_dim: int, transformer_layers: int,
                use_linear_projection: bool) -> Optional[nn.ModuleList]:
    if not cross_attention:
        return None
    return nn.ModuleList([
        Transformer2DModel(channels, num_heads, channels // num_heads,
                           context_dim, transformer_layers,
                           use_linear_projection)
        for _ in range(n)
    ])


class DownBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: int, *, num_layers: int, add_downsample: bool,
                 cross_attention: bool, num_heads: int = 8,
                 context_dim: int = 768, transformer_layers: int = 1,
                 use_linear_projection: bool = False, eps: float = 1e-5,
                 groups: int = 32):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if i == 0 else out_channels,
                          out_channels, temb_channels, eps, groups)
            for i in range(num_layers)
        ])
        self.attentions = _attentions(
            cross_attention, num_layers, out_channels, num_heads, context_dim,
            transformer_layers, use_linear_projection)
        self.downsamplers = (nn.ModuleList([Downsample2D(out_channels)])
                             if add_downsample else None)

    def forward(self, x: torch.Tensor, temb: torch.Tensor,
                context: torch.Tensor,
                add_samples: Optional[Sequence[torch.Tensor]] = None,
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        taps = iter(add_samples) if add_samples is not None else None
        skips = []
        for i, resnet in enumerate(self.resnets):
            x = resnet(x, temb)
            if self.attentions is not None:
                x = self.attentions[i](x, context)
            if taps is not None:
                x = x + next(taps)
            skips.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            if taps is not None:
                x = x + next(taps)
            skips.append(x)
        return x, skips


class MidBlock(nn.Module):
    """resnet -> transformer -> resnet."""

    def __init__(self, channels: int, temb_channels: int, *, num_heads: int,
                 context_dim: int, transformer_layers: int = 1,
                 use_linear_projection: bool = False, eps: float = 1e-5,
                 groups: int = 32):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(channels, channels, temb_channels, eps, groups)
            for _ in range(2)
        ])
        self.attentions = _attentions(True, 1, channels, num_heads,
                                      context_dim, transformer_layers,
                                      use_linear_projection)

    def forward(self, x, temb, context):
        x = self.resnets[0](x, temb)
        x = self.attentions[0](x, context)
        return self.resnets[1](x, temb)


class UpBlock(nn.Module):
    """Each resnet takes the concat of the running feature and one skip,
    popped from the end of ``skips``. Returns (x, emitted features)."""

    def __init__(self, prev_channels: int, out_channels: int,
                 skip_in_channels: int, temb_channels: int, *, num_layers: int,
                 add_upsample: bool, cross_attention: bool, num_heads: int = 8,
                 context_dim: int = 768, transformer_layers: int = 1,
                 use_linear_projection: bool = False, eps: float = 1e-5,
                 groups: int = 32):
        super().__init__()
        resnets = []
        for i in range(num_layers):
            skip = skip_in_channels if i == num_layers - 1 else out_channels
            res_in = prev_channels if i == 0 else out_channels
            resnets.append(ResnetBlock2D(res_in + skip, out_channels,
                                         temb_channels, eps, groups))
        self.resnets = nn.ModuleList(resnets)
        self.attentions = _attentions(
            cross_attention, num_layers, out_channels, num_heads, context_dim,
            transformer_layers, use_linear_projection)
        self.upsamplers = (nn.ModuleList([Upsample2D(out_channels)])
                           if add_upsample else None)

    def forward(self, x: torch.Tensor, temb: torch.Tensor,
                skips: Sequence[torch.Tensor], context: torch.Tensor,
                output_size: Optional[tuple] = None,
                add_samples: Optional[Sequence[torch.Tensor]] = None,
                emit: bool = False,
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        taps = iter(add_samples) if add_samples is not None else None
        emitted = []
        skips = list(skips)
        for i, resnet in enumerate(self.resnets):
            x = torch.cat([x, skips.pop()], dim=-1)
            x = resnet(x, temb)
            if self.attentions is not None:
                x = self.attentions[i](x, context)
            if emit:
                emitted.append(x)
            if taps is not None:
                x = x + next(taps)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x, output_size)
            if emit:
                emitted.append(x)
            if taps is not None:
                x = x + next(taps)
        return x, emitted
