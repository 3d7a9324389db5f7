"""BrushNet with preserved cross-attention: the ppt-v2 side branch, on NHWC
activations with the diffusers ``BrushNetModel`` parameter names.

A full UNet (down, mid, up) whose input is concat(noisy latent, 5-channel
conditioning) through ``conv_in_condition``, and whose features leave
through 1x1 "zero" convs (zero-initialised in training; any weights here):

- 12 down taps: conv_in_condition's output, one per down resnet (after its
  attention), one per downsampler;
- 1 mid tap, after the mid block;
- 15 up taps: one per up resnet (after its attention), one per upsampler,
  each taken before any tap would be added.

``forward`` returns (down taps, mid tap, up taps) in the order the base
UNet consumes them (``models.unet``), each times ``conditioning_scale``, or
times ``logspace(-1, 0, 28) * conditioning_scale`` in guess mode.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
from torch import nn

from powerpaint_tpu_torch.core.config import BrushNetConfig
from powerpaint_tpu_torch.models.layers import Conv2D
from powerpaint_tpu_torch.models.unet import add_blocks, embed_time


class BrushNetModel(nn.Module):
    def __init__(self, config: BrushNetConfig):
        super().__init__()
        self.config = config
        cfg = config.base
        ch = cfg.block_out_channels
        self.conv_in_condition = Conv2D(
            cfg.in_channels + config.conditioning_channels, ch[0], 3, padding=1)
        add_blocks(self, cfg)
        self.brushnet_down_blocks = nn.ModuleList(
            [Conv2D(c, c, 1) for c in cfg.down_tap_channels()])
        self.brushnet_mid_block = Conv2D(cfg.mid_tap_channels(),
                                         cfg.mid_tap_channels(), 1)
        self.brushnet_up_blocks = nn.ModuleList(
            [Conv2D(c, c, 1) for c in cfg.up_tap_channels()])

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                brushnet_cond: torch.Tensor, conditioning_scale: float = 1.0,
                guess_mode: bool = False,
                ) -> Tuple[List[torch.Tensor], torch.Tensor, List[torch.Tensor]]:
        """sample (B, H, W, 4) noisy latents, timesteps () or (B,),
        encoder_hidden_states (B, 77, D) task-token embeddings,
        brushnet_cond (B, H, W, 5) -> the 28 taps in the compute dtype."""
        cfg = self.config.base
        dtype = self.conv_in_condition.weight.dtype
        temb = embed_time(self.time_embedding, cfg, timesteps, sample.shape[0],
                          sample.device, dtype)
        context = encoder_hidden_states.to(dtype)

        x = self.conv_in_condition(
            torch.cat([sample.to(dtype), brushnet_cond.to(dtype)], dim=-1))
        down = [x]
        for block in self.down_blocks:
            x, feats = block(x, temb, context)
            down.extend(feats)
        x = self.mid_block(x, temb, context)
        mid = x

        skips = list(down)
        up = []
        for block in self.up_blocks:
            k = len(block.resnets)
            block_skips, skips = skips[-k:], skips[:-k]
            output_size = tuple(skips[-1].shape[1:3]) if skips else None
            x, feats = block(x, temb, block_skips, context, output_size,
                             emit=True)
            up.extend(feats)

        down = [zc(f) for zc, f in zip(self.brushnet_down_blocks, down)]
        mid = self.brushnet_mid_block(mid)
        up = [zc(f) for zc, f in zip(self.brushnet_up_blocks, up)]

        n = len(down) + 1 + len(up)
        if guess_mode:
            scales = [float(s) * conditioning_scale
                      for s in np.logspace(-1, 0, n, dtype=np.float32)]
        else:
            scales = [conditioning_scale] * n
        down = [t * s for t, s in zip(down, scales)]
        mid = mid * scales[len(down)]
        up = [t * s for t, s in zip(up, scales[len(down) + 1:])]
        return down, mid, up
