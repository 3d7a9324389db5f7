"""AutoencoderKL (SD1.5 VAE) on NHWC activations, diffusers parameter
names: encode to (mean, logvar) and decode. The mid-block attention is
one-head self-attention over every latent pixel (4096 tokens at 512
channels for a 512x512 image) through the flash-attention kernel."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from powerpaint_tpu_torch.core.config import VAEConfig
from powerpaint_tpu_torch.models.layers import Conv2D, GroupNorm
from powerpaint_tpu_torch.models.resnet import ResnetBlock2D, Upsample2D
from powerpaint_tpu_torch.ops.attention import attention


class VAEAttention(nn.Module):
    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm(groups, channels, 1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        y = self.group_norm(x).reshape(b, h * w, 1, c)
        out = attention(self.to_q(y), self.to_k(y), self.to_v(y))
        return self.to_out[0](out).reshape(b, h, w, c) + x


class VAEDownsample2D(nn.Module):
    """Pad (0, 1, 0, 1) then a VALID stride-2 conv (not the UNet's
    symmetric padding 1)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2D(channels, channels, 3, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 0, 0, 1, 0, 1)))  # NHWC: W right, H bottom


class VAEMidBlock(nn.Module):
    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(channels, channels, None, 1e-6, groups)
            for _ in range(2)
        ])
        self.attentions = nn.ModuleList([VAEAttention(channels, groups)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class DownEncoderBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_layers: int,
                 add_downsample: bool, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if i == 0 else out_channels,
                          out_channels, None, 1e-6, groups)
            for i in range(num_layers)
        ])
        self.downsamplers = (nn.ModuleList([VAEDownsample2D(out_channels)])
                             if add_downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
        return x


class UpDecoderBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_layers: int,
                 add_upsample: bool, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if i == 0 else out_channels,
                          out_channels, None, 1e-6, groups)
            for i in range(num_layers)
        ])
        self.upsamplers = (nn.ModuleList([Upsample2D(out_channels)])
                           if add_upsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch = cfg.block_out_channels
        g = cfg.norm_num_groups
        self.conv_in = Conv2D(cfg.in_channels, ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList([
            DownEncoderBlock2D(ch[max(i - 1, 0)], ch[i], cfg.layers_per_block,
                               i < len(ch) - 1, g)
            for i in range(len(ch))
        ])
        self.mid_block = VAEMidBlock(ch[-1], g)
        self.conv_norm_out = GroupNorm(g, ch[-1], 1e-6)
        self.conv_out = Conv2D(ch[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return self.conv_out(self.conv_norm_out(x, silu=True))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev = tuple(reversed(cfg.block_out_channels))
        g = cfg.norm_num_groups
        self.conv_in = Conv2D(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = VAEMidBlock(rev[0], g)
        self.up_blocks = nn.ModuleList([
            UpDecoderBlock2D(rev[max(i - 1, 0)], rev[i],
                             cfg.layers_per_block + 1, i < len(rev) - 1, g)
            for i in range(len(rev))
        ])
        self.conv_norm_out = GroupNorm(g, rev[-1], 1e-6)
        self.conv_out = Conv2D(rev[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(self.conv_norm_out(x, silu=True))


class AutoencoderKL(nn.Module):
    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = Conv2D(2 * config.latent_channels,
                                 2 * config.latent_channels, 1)
        self.post_quant_conv = Conv2D(config.latent_channels,
                                      config.latent_channels, 1)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, H, W, 3) in [-1, 1] -> (mean, logvar), each (B, H/8, W/8, L),
        unscaled, in the compute dtype."""
        x = x.to(self.quant_conv.weight.dtype)
        moments = self.quant_conv(self.encoder(x))
        mean, logvar = moments.chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Unscaled latents (callers divide by scaling_factor) -> image."""
        z = z.to(self.post_quant_conv.weight.dtype)
        return self.decoder(self.post_quant_conv(z))
