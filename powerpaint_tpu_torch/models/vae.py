"""AutoencoderKL (SD1.5 VAE) on NHWC activations, diffusers parameter
names: encode to (mean, logvar) and decode. The mid-block attention is
one-head self-attention over every latent pixel (4096 tokens at 512
channels for a 512x512 image) through the flash-attention kernel.

An asymmetric VAE (``config.asymmetric``, diffusers'
``AsymmetricAutoencoderKL``, the reference's optional higher-fidelity v1
decode) has a ``ConditionalDecoder``: its own widths and depth, and a
condition tower over the known region of the image whose features replace
the decoder's outside the hole (``decode_with_condition``). Its mid
attention is one head over all the decoder's top channels: head dim 768
or 1024 for the published decoders.

``decode_tiled`` decodes a large canvas in overlapping latent tiles with
feathered seams (a library function, as in the JAX package)."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from powerpaint_tpu_torch.core.config import VAEConfig
from powerpaint_tpu_torch.models.layers import Conv2D, GroupNorm
from powerpaint_tpu_torch.models.resnet import ResnetBlock2D, Upsample2D
from powerpaint_tpu_torch.ops.attention import attention
from powerpaint_tpu_torch.parallel import sequence


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
        out = attention(self.to_q(y), self.to_k(y), self.to_v(y),
                        self_attention=True)
        return self.to_out[0](out).reshape(b, h, w, c) + x


class VAEDownsample2D(nn.Module):
    """Pad (0, 1, 0, 1) then a VALID stride-2 conv (not the UNet's
    symmetric padding 1)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2D(channels, channels, 3, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if sequence.current() is None:
            return self.conv(F.pad(x, (0, 0, 0, 1, 0, 1)))  # NHWC: W right, H bottom
        # this rank's rows: the row below from the next rank, the zero row
        # at the canvas's bottom on the last
        return sequence.conv_rows(F.pad(x, (0, 0, 0, 1)), self.conv, 0, 1)


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
        rev = tuple(reversed(cfg.up_channels))
        g = cfg.norm_num_groups
        self.conv_in = Conv2D(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = VAEMidBlock(rev[0], g)
        self.up_blocks = nn.ModuleList([
            UpDecoderBlock2D(rev[max(i - 1, 0)], rev[i], cfg.up_layers + 1,
                             i < len(rev) - 1, g)
            for i in range(len(rev))
        ])
        self.conv_norm_out = GroupNorm(g, rev[-1], 1e-6)
        self.conv_out = Conv2D(rev[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(self.conv_norm_out(x, silu=True))


class MaskConditionEncoder(nn.Module):
    """The asymmetric decoder's condition tower: convs of ``spec`` ((kernel,
    stride, out_ch), ...; 3x3 stride 1 and 4x4 stride 2, each with padding
    1, on cuDNN) over the masked image, a ReLU between them. Returns each
    conv's output before its ReLU: the features the decoder blends in."""

    def __init__(self, in_channels: int, spec: Sequence[Tuple[int, int, int]]):
        super().__init__()
        chans = [in_channels] + [ch for _, _, ch in spec]
        self.layers = nn.ModuleList([
            Conv2D(chans[i], ch, k, stride=s, padding=1)
            for i, (k, s, ch) in enumerate(spec)])

    def forward(self, x: torch.Tensor) -> list:
        feats = []
        for layer in self.layers:
            x = layer(x)
            feats.append(x)
            x = F.relu(x)
        return feats


class ConditionalDecoder(Decoder):
    """The decoder with known-region feature injection: before each up
    block, and once at full resolution, a sample whose (H, W, C) matches a
    condition feature becomes ``sample * m + feature * (1 - m)``, ``m`` the
    hole mask (1 in the hole) resized nearest (half-pixel centres) to the
    sample's size, so the known region comes from the condition tower."""

    def __init__(self, cfg: VAEConfig):
        super().__init__(cfg)
        self.condition_encoder = MaskConditionEncoder(cfg.in_channels,
                                                      cfg.condition_layers)

    def forward(self, z: torch.Tensor, image: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        x = self.mid_block(self.conv_in(z))
        masked = ((1.0 - mask) * image).to(x.dtype)
        by_shape = {tuple(f.shape[1:]): f for f in self.condition_encoder(masked)}

        def blend(sample):
            feat = by_shape.get(tuple(sample.shape[1:]))
            if feat is None:
                return sample
            m = F.interpolate(mask.permute(0, 3, 1, 2), size=sample.shape[1:3],
                              mode="nearest-exact").permute(0, 2, 3, 1)
            m = m.to(sample.dtype)
            return sample * m + feat * (1.0 - m)

        for block in self.up_blocks:
            x = block(blend(x))
        x = blend(x)
        return self.conv_out(self.conv_norm_out(x, silu=True))


class AutoencoderKL(nn.Module):
    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = (ConditionalDecoder(config) if config.asymmetric
                        else Decoder(config))
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
        if self.config.asymmetric:
            raise ValueError("asymmetric VAE decode needs (image, mask); call "
                             "decode_with_condition")
        z = z.to(self.post_quant_conv.weight.dtype)
        return self.decoder(self.post_quant_conv(z))

    def decode_with_condition(self, z: torch.Tensor, image: torch.Tensor,
                              mask: torch.Tensor) -> torch.Tensor:
        """Asymmetric decode: unscaled latents (B, h, w, L), the full image
        (B, H, W, 3) in [-1, 1] and the hole mask (B, H, W, 1), 1 in the
        hole -> image."""
        if not self.config.asymmetric:
            raise ValueError("decode_with_condition needs asymmetric=True")
        z = z.to(self.post_quant_conv.weight.dtype)
        return self.decoder(self.post_quant_conv(z), image.float(), mask.float())


def decode_tiled(vae: AutoencoderKL, z: torch.Tensor, *, tile: int = 64,
                 overlap: int = 16) -> torch.Tensor:
    """Decode unscaled latents z (B, h, w, L) (callers divide by
    scaling_factor first) in (tile x tile)-latent windows that overlap by
    ``overlap`` latents, the last window of a row or column clamped to the
    canvas; each window's image is weighted by a linear ramp across the
    overlap band, accumulated in fp32 and divided by the summed weights.
    Returns z's dtype. A canvas no larger than one tile is one ``decode``."""
    b, h, w, _ = z.shape
    if h <= tile and w <= tile:
        return vae.decode(z)
    stride = tile - overlap
    ny = max(1, -(-(h - overlap) // stride))
    nx = max(1, -(-(w - overlap) // stride))
    f = 8  # the VAE's spatial scale factor
    th, tw = min(tile, h), min(tile, w)

    def ramp(n):
        up = torch.arange(n * f, dtype=torch.float32, device=z.device) + 1.0
        down = torch.arange(n * f, 0.0, -1.0, dtype=torch.float32,
                            device=z.device)
        return torch.clamp(torch.minimum(up, down) / max(overlap * f, 1),
                           max=1.0)

    wmap = (ramp(th)[:, None] * ramp(tw)[None, :])[None, :, :, None]
    out = weight = None
    for iy in range(ny):
        for ix in range(nx):
            y0 = min(iy * stride, max(h - tile, 0))
            x0 = min(ix * stride, max(w - tile, 0))
            dec = vae.decode(z[:, y0:y0 + th, x0:x0 + tw]).float()
            if out is None:
                out = torch.zeros((b, h * f, w * f, dec.shape[-1]),
                                  dtype=torch.float32, device=z.device)
                weight = torch.zeros((1, h * f, w * f, 1), dtype=torch.float32,
                                     device=z.device)
            rows = slice(y0 * f, (y0 + th) * f)
            cols = slice(x0 * f, (x0 + tw) * f)
            out[:, rows, cols] += dec * wmap
            weight[:, rows, cols] += wmap
    return (out / torch.clamp(weight, min=1e-8)).to(z.dtype)
