"""ControlNet: the ppt-v1 + ControlNet side branch, on NHWC activations with
the diffusers ``ControlNetModel`` parameter names.

The down and mid half of the base UNet's config, on the noisy latent only:
the branch's ``conv_in`` sees the 4 latent channels, not the 9-channel
inpainting input of its base config. The control image, in [0, 1], enters
through the conditioning embedding (a stack of 3x3 convs, three of them
stride 2, from the image's size to the latent's), added to conv_in's
output. Each skip connection (conv_in's, one per down resnet after its
attention, one per downsampler) leaves through a 1x1 "zero" conv
(``controlnet_down_blocks``), and the mid block's output through
``controlnet_mid_block``.

``forward`` returns the 12 down residuals and the mid residual, each times
``conditioning_scale``, or times ``logspace(-1, 0, 13) * conditioning_scale``
in guess mode. The ResNet units run the fused GroupNorm + SiLU conv kernel
(the int8 unit where ``ops.conv.int8_site`` admits it), the transformers
the attention and norm kernels; the conditioning embedding's convs and the
1x1 convs stay on cuDNN.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from powerpaint_tpu_torch.core.config import ControlNetConfig
from powerpaint_tpu_torch.models.layers import Conv2D
from powerpaint_tpu_torch.models.unet import add_encoder, embed_time


class ControlNetConditioningEmbedding(nn.Module):
    """conv 3 -> 16, then per step of ``embed_channels`` a stride-1 and a
    stride-2 conv, each followed by SiLU, and conv_out to the UNet's first
    width."""

    def __init__(self, in_channels: int, out_channels: int,
                 embed_channels: Sequence[int]):
        super().__init__()
        self.conv_in = Conv2D(in_channels, embed_channels[0], 3, padding=1)
        blocks = []
        for c_in, c_out in zip(embed_channels[:-1], embed_channels[1:]):
            blocks.append(Conv2D(c_in, c_in, 3, padding=1))
            blocks.append(Conv2D(c_in, c_out, 3, stride=2, padding=1))
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = Conv2D(embed_channels[-1], out_channels, 3, padding=1)

    def forward(self, cond: torch.Tensor) -> torch.Tensor:
        x = F.silu(self.conv_in(cond))
        for block in self.blocks:
            x = F.silu(block(x))
        return self.conv_out(x)


class ControlNetModel(nn.Module):
    def __init__(self, config: ControlNetConfig):
        super().__init__()
        self.config = config
        cfg = config.base
        ch = cfg.block_out_channels
        # the noisy latent alone: the UNet's output channels
        self.conv_in = Conv2D(cfg.out_channels, ch[0], 3, padding=1)
        self.controlnet_cond_embedding = ControlNetConditioningEmbedding(
            config.conditioning_channels, ch[0],
            config.conditioning_embedding_out_channels)
        add_encoder(self, cfg)
        self.controlnet_down_blocks = nn.ModuleList(
            [Conv2D(c, c, 1) for c in cfg.controlnet_residual_channels()])
        self.controlnet_mid_block = Conv2D(ch[-1], ch[-1], 1)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                controlnet_cond: torch.Tensor, conditioning_scale: float = 1.0,
                guess_mode: bool = False,
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """sample (B, H, W, 4) noisy latents, timesteps () or (B,),
        encoder_hidden_states (B, 77, D), controlnet_cond (B, 8H, 8W, 3)
        the control image in [0, 1] -> (12 down residuals, mid residual) in
        the compute dtype."""
        cfg = self.config.base
        dtype = self.conv_in.weight.dtype
        temb = embed_time(self.time_embedding, cfg, timesteps, sample.shape[0],
                          sample.device, dtype)
        context = encoder_hidden_states.to(dtype)

        x = self.conv_in(sample.to(dtype)) + self.controlnet_cond_embedding(
            controlnet_cond.to(dtype))
        feats = [x]
        for block in self.down_blocks:
            x, skips = block(x, temb, context)
            feats.extend(skips)
        x = self.mid_block(x, temb, context)

        down = [zc(f) for zc, f in zip(self.controlnet_down_blocks, feats)]
        mid = self.controlnet_mid_block(x)
        if guess_mode:
            scales = [float(s) * conditioning_scale
                      for s in np.logspace(-1, 0, len(down) + 1,
                                           dtype=np.float32)]
        else:
            scales = [conditioning_scale] * (len(down) + 1)
        return [t * s for t, s in zip(down, scales)], mid * scales[-1]
