"""Tiny model configs for CPU-runnable tests (same widths as the JAX
package's ``testing.tiny_v1_config``, ``testing.tiny_v2_config`` and
``testing.tiny_v1_controlnet_config``; the tiny DPT of its
``tests/test_dpt_oracle.py``, the tiny CLIP tower of its
``tests/test_clip_vision_safety.py`` and the tiny asymmetric VAE of its
``tests/test_asymmetric_vae.py``)."""

from __future__ import annotations

from powerpaint_tpu_torch.core.config import (
    BrushNetConfig,
    CLIPTextConfig,
    CLIPVisionConfig,
    ControlNetConfig,
    DPTConfig,
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


# the condition tower of the JAX package's tests/test_asymmetric_vae.py: one
# feature at each of the tiny decoder's sample shapes (H, W, C) on a 32^2
# (or any 8k x 8k) image
COND_SPEC = ((3, 1, 16), (4, 2, 32), (4, 2, 32), (4, 2, 32))


def tiny_asymmetric_vae() -> VAEConfig:
    return tiny_vae().replace(asymmetric=True, condition_layers=COND_SPEC)


def tiny_wide_asymmetric_vae() -> VAEConfig:
    """A decoder wider (24, 24, 48, 48) and deeper (3 resnets an up block)
    than its encoder, and a tower to match."""
    return tiny_vae().replace(
        asymmetric=True, up_block_out_channels=(24, 24, 48, 48),
        layers_per_up_block=2,
        condition_layers=((3, 1, 24), (4, 2, 48), (4, 2, 48), (4, 2, 48)))


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


def tiny_v1_controlnet_config() -> PowerPaintConfig:
    return PowerPaintConfig(
        version="ppt-v1",
        unet=tiny_unet(9),
        vae=tiny_vae(),
        text_encoder=tiny_text(30),
        controlnet=ControlNetConfig(
            base=tiny_unet(4),
            conditioning_embedding_out_channels=(16, 16, 16, 16),
        ),
    )


def tiny_dpt_config() -> DPTConfig:
    """A hybrid DPT of BiT (8, 16, 32) x (1, 1, 1) with 2 groups and a
    2-layer ViT of width 32 at 64 x 64: every part of the network (the
    strided units, the readout, the 0.5 resize, the four fusion layers)."""
    return DPTConfig(
        embedding_size=8, bit_hidden_sizes=(8, 16, 32), bit_depths=(1, 1, 1),
        bit_num_groups=2, hidden_size=32, num_layers=2, num_heads=2,
        intermediate_size=64, image_size=64, patch_size=16,
        vit_out_layers=(0, 1), neck_hidden_sizes=(8, 16, 32, 32),
        reassemble_factors=(1.0, 1.0, 1.0, 0.5), fusion_hidden_size=16)


def tiny_clip_vision_config() -> CLIPVisionConfig:
    return CLIPVisionConfig(hidden_size=32, intermediate_size=64,
                            num_hidden_layers=2, num_attention_heads=2,
                            image_size=32, patch_size=8, projection_dim=16)
