"""Tiny model configs for CPU-runnable tests (same widths as the JAX
package's ``testing.tiny_v1_config`` and ``testing.tiny_v2_config``)."""

from __future__ import annotations

from powerpaint_tpu_torch.core.config import (
    BrushNetConfig,
    CLIPTextConfig,
    PowerPaintConfig,
    UNetConfig,
    VAEConfig,
)


def tiny_unet(in_channels: int = 9) -> UNetConfig:
    return UNetConfig(
        sample_size=8,
        in_channels=in_channels,
        block_out_channels=(32, 64, 64, 64),
        attention_head_dim=2,
        cross_attention_dim=32,
    )


def tiny_vae() -> VAEConfig:
    return VAEConfig(block_out_channels=(16, 16, 32, 32), layers_per_block=1,
                     norm_num_groups=8)


def tiny_text(num_external: int = 30) -> CLIPTextConfig:
    return CLIPTextConfig(
        vocab_size=1024,
        hidden_size=32,
        intermediate_size=64,
        num_hidden_layers=2,
        num_attention_heads=2,
        num_external_tokens=num_external,
    )


def tiny_v1_config() -> PowerPaintConfig:
    return PowerPaintConfig(
        version="ppt-v1",
        unet=tiny_unet(9),
        vae=tiny_vae(),
        text_encoder=tiny_text(30),
    )


def tiny_v2_config() -> PowerPaintConfig:
    return PowerPaintConfig(
        version="ppt-v2",
        unet=tiny_unet(4),
        vae=tiny_vae(),
        text_encoder=tiny_text(30),
        brushnet=BrushNetConfig(base=tiny_unet(4)),
    )
