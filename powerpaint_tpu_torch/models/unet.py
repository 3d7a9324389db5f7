"""Conditional UNet2D (SD1.5 family: the 9-channel inpainting UNet of ppt-v1,
the 4-channel base UNet of ppt-v2) on NHWC activations, with diffusers
``UNet2DConditionModel`` parameter names, and BrushNet tap injection.

The BrushNet branch's features arrive as flat sequences in consumption
order, sliced per block by the config's tap schedule (``_down_tap_counts``,
``_up_tap_counts``), as in the JAX package: one tap after conv_in (added
AFTER conv_in's skip is recorded), then the down blocks' taps, one after
the mid block, then the up blocks' taps."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from powerpaint_tpu_torch.core.config import (
    CROSS_ATTN_DOWN,
    CROSS_ATTN_UP,
    MID_CROSS_ATTN,
    UNetConfig,
)
from powerpaint_tpu_torch.models.blocks import DownBlock, MidBlock, UpBlock
from powerpaint_tpu_torch.models.layers import (
    Conv2D,
    GroupNorm,
    TimestepEmbedding,
    timestep_sinusoid,
)


def _down_tap_counts(cfg: UNetConfig) -> Tuple[int, ...]:
    """BrushNet taps per down block: one per resnet, one per downsampler."""
    n = len(cfg.down_block_types)
    return tuple(cfg.layers_per_block + (0 if i == n - 1 else 1)
                 for i in range(n))


def _up_tap_counts(cfg: UNetConfig) -> Tuple[int, ...]:
    """BrushNet taps per up block: one per resnet, one per upsampler."""
    n = len(cfg.up_block_types)
    return tuple(cfg.layers_per_block + 1 + (0 if i == n - 1 else 1)
                 for i in range(n))


def add_blocks(model: nn.Module, cfg: UNetConfig) -> None:
    """Give ``model`` the time embedding, down, mid and up blocks of
    ``cfg``: what the UNet and the BrushNet branch share."""
    if cfg.mid_block_type != MID_CROSS_ATTN:
        raise ValueError(f"unsupported mid block {cfg.mid_block_type}")
    ch = cfg.block_out_channels
    temb_ch = ch[0] * 4
    attn = dict(num_heads=cfg.num_heads,
                context_dim=cfg.cross_attention_dim,
                transformer_layers=cfg.transformer_layers_per_block,
                use_linear_projection=cfg.use_linear_projection,
                eps=cfg.norm_eps, groups=cfg.norm_num_groups)
    model.time_embedding = TimestepEmbedding(ch[0], temb_ch)

    model.down_blocks = nn.ModuleList()
    for i, kind in enumerate(cfg.down_block_types):
        model.down_blocks.append(DownBlock(
            ch[max(i - 1, 0)], ch[i], temb_ch,
            num_layers=cfg.layers_per_block,
            add_downsample=i < len(ch) - 1,
            cross_attention=kind == CROSS_ATTN_DOWN, **attn))
    model.mid_block = MidBlock(ch[-1], temb_ch, **attn)

    rev = tuple(reversed(ch))
    model.up_blocks = nn.ModuleList()
    for i, kind in enumerate(cfg.up_block_types):
        model.up_blocks.append(UpBlock(
            rev[max(i - 1, 0)], rev[i], rev[min(i + 1, len(ch) - 1)],
            temb_ch, num_layers=cfg.layers_per_block + 1,
            add_upsample=i < len(ch) - 1,
            cross_attention=kind == CROSS_ATTN_UP, **attn))


def embed_time(time_embedding: TimestepEmbedding, cfg: UNetConfig,
               timesteps, batch: int, device,
               dtype: torch.dtype) -> torch.Tensor:
    """Sinusoid of () or (B,) timesteps, then the embedding MLP."""
    timesteps = torch.as_tensor(timesteps, device=device)
    if timesteps.dim() == 0:
        timesteps = timesteps.expand(batch)
    t_emb = timestep_sinusoid(
        timesteps, cfg.block_out_channels[0],
        flip_sin_to_cos=cfg.flip_sin_to_cos,
        downscale_freq_shift=cfg.freq_shift).to(dtype)
    return time_embedding(t_emb)


class UNet2DConditionModel(nn.Module):
    def __init__(self, config: UNetConfig):
        super().__init__()
        self.config = cfg = config
        ch = cfg.block_out_channels
        self.conv_in = Conv2D(cfg.in_channels, ch[0], cfg.conv_in_kernel,
                              padding=(cfg.conv_in_kernel - 1) // 2)
        add_blocks(self, cfg)
        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, ch[0], cfg.norm_eps)
        self.conv_out = Conv2D(ch[0], cfg.out_channels, cfg.conv_out_kernel,
                               padding=(cfg.conv_out_kernel - 1) // 2)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor, *,
                down_block_add_samples: Optional[Sequence[torch.Tensor]] = None,
                mid_block_add_sample: Optional[torch.Tensor] = None,
                up_block_add_samples: Optional[Sequence[torch.Tensor]] = None,
                ) -> torch.Tensor:
        """sample (B, H, W, C_in), timesteps () or (B,), encoder_hidden_states
        (B, 77, D) -> (B, H, W, C_out) in the compute dtype. The BrushNet
        taps, when given: 1 + sum(_down_tap_counts) down, one mid,
        sum(_up_tap_counts) up."""
        cfg = self.config
        dtype = self.conv_in.weight.dtype
        temb = embed_time(self.time_embedding, cfg, timesteps, sample.shape[0],
                          sample.device, dtype)
        context = encoder_hidden_states.to(dtype)

        x = self.conv_in(sample.to(dtype))
        skips = [x]
        down_taps = None
        if down_block_add_samples is not None:
            down_taps = list(down_block_add_samples)
            x = x + down_taps.pop(0)
        for block, n in zip(self.down_blocks, _down_tap_counts(cfg)):
            taps = None
            if down_taps is not None:
                taps, down_taps = down_taps[:n], down_taps[n:]
            x, block_skips = block(x, temb, context, taps)
            skips.extend(block_skips)

        x = self.mid_block(x, temb, context)
        if mid_block_add_sample is not None:
            x = x + mid_block_add_sample

        up_taps = (list(up_block_add_samples)
                   if up_block_add_samples is not None else None)
        for block, n in zip(self.up_blocks, _up_tap_counts(cfg)):
            k = len(block.resnets)
            block_skips, skips = skips[-k:], skips[:-k]
            output_size = tuple(skips[-1].shape[1:3]) if skips else None
            taps = None
            if up_taps is not None:
                taps, up_taps = up_taps[:n], up_taps[n:]
            x, _ = block(x, temb, block_skips, context, output_size, taps)

        return self.conv_out(self.conv_norm_out(x, silu=True))
