"""Conditional UNet2D (SD1.5 family, 9-channel inpainting for ppt-v1) on
NHWC activations, with diffusers ``UNet2DConditionModel`` parameter names."""

from __future__ import annotations

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


class UNet2DConditionModel(nn.Module):
    def __init__(self, config: UNetConfig):
        super().__init__()
        if config.mid_block_type != MID_CROSS_ATTN:
            raise ValueError(f"unsupported mid block {config.mid_block_type}")
        self.config = cfg = config
        ch = cfg.block_out_channels
        temb_ch = ch[0] * 4
        attn = dict(num_heads=cfg.num_heads,
                    context_dim=cfg.cross_attention_dim,
                    transformer_layers=cfg.transformer_layers_per_block,
                    use_linear_projection=cfg.use_linear_projection,
                    eps=cfg.norm_eps, groups=cfg.norm_num_groups)
        self.conv_in = Conv2D(cfg.in_channels, ch[0], cfg.conv_in_kernel,
                              padding=(cfg.conv_in_kernel - 1) // 2)
        self.time_embedding = TimestepEmbedding(ch[0], temb_ch)

        self.down_blocks = nn.ModuleList()
        for i, kind in enumerate(cfg.down_block_types):
            self.down_blocks.append(DownBlock(
                ch[max(i - 1, 0)], ch[i], temb_ch,
                num_layers=cfg.layers_per_block,
                add_downsample=i < len(ch) - 1,
                cross_attention=kind == CROSS_ATTN_DOWN, **attn))
        self.mid_block = MidBlock(ch[-1], temb_ch, **attn)

        rev = tuple(reversed(ch))
        self.up_blocks = nn.ModuleList()
        for i, kind in enumerate(cfg.up_block_types):
            self.up_blocks.append(UpBlock(
                rev[max(i - 1, 0)], rev[i], rev[min(i + 1, len(ch) - 1)],
                temb_ch, num_layers=cfg.layers_per_block + 1,
                add_upsample=i < len(ch) - 1,
                cross_attention=kind == CROSS_ATTN_UP, **attn))

        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, ch[0], cfg.norm_eps)
        self.conv_out = Conv2D(ch[0], cfg.out_channels, cfg.conv_out_kernel,
                               padding=(cfg.conv_out_kernel - 1) // 2)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor) -> torch.Tensor:
        """sample (B, H, W, C_in), timesteps () or (B,), encoder_hidden_states
        (B, 77, D) -> (B, H, W, C_out) in the compute dtype."""
        cfg = self.config
        dtype = self.conv_in.weight.dtype
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(sample.shape[0])
        t_emb = timestep_sinusoid(
            timesteps, cfg.block_out_channels[0],
            flip_sin_to_cos=cfg.flip_sin_to_cos,
            downscale_freq_shift=cfg.freq_shift).to(dtype)
        temb = self.time_embedding(t_emb)
        context = encoder_hidden_states.to(dtype)

        x = self.conv_in(sample.to(dtype))
        skips = [x]
        for block in self.down_blocks:
            x, block_skips = block(x, temb, context)
            skips.extend(block_skips)

        x = self.mid_block(x, temb, context)

        for block in self.up_blocks:
            n = len(block.resnets)
            block_skips, skips = skips[-n:], skips[:-n]
            output_size = tuple(skips[-1].shape[1:3]) if skips else None
            x = block(x, temb, block_skips, context, output_size)

        return self.conv_out(self.conv_norm_out(x, silu=True))
