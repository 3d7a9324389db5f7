"""Model / pipeline configuration dataclasses.

The port's own copy of the ppt-v1 and ppt-v2 parts of
``powerpaint_tpu.core.config``:
frozen dataclasses that are the single source of truth for block topology,
with the same field names and defaults, so a config serialized by either
package loads in the other (unknown keys are ignored by ``from_dict``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional, Tuple


def _freeze(obj):
    if isinstance(obj, list):
        return tuple(_freeze(x) for x in obj)
    return obj


class _ConfigBase:
    """JSON round-trip + dict conversion shared by all config dataclasses."""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "Any":
        fields = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: _freeze(v) for k, v in d.items() if k in fields}
        return cls(**kwargs)

    @classmethod
    def from_json(cls, s: str) -> "Any":
        return cls.from_dict(json.loads(s))

    def replace(self, **kwargs):
        return dataclasses.replace(self, **kwargs)


CROSS_ATTN_DOWN = "CrossAttnDownBlock2D"
DOWN = "DownBlock2D"
CROSS_ATTN_UP = "CrossAttnUpBlock2D"
UP = "UpBlock2D"
MID_CROSS_ATTN = "UNetMidBlock2DCrossAttn"


@dataclasses.dataclass(frozen=True)
class UNetConfig(_ConfigBase):
    """SD1.5-family conditional UNet; the defaults are the 9-channel
    ``runwayml/stable-diffusion-inpainting`` UNet that ppt-v1 fine-tunes."""

    sample_size: int = 64
    in_channels: int = 9
    out_channels: int = 4
    down_block_types: Tuple[str, ...] = (
        CROSS_ATTN_DOWN,
        CROSS_ATTN_DOWN,
        CROSS_ATTN_DOWN,
        DOWN,
    )
    mid_block_type: str = MID_CROSS_ATTN
    up_block_types: Tuple[str, ...] = (
        UP,
        CROSS_ATTN_UP,
        CROSS_ATTN_UP,
        CROSS_ATTN_UP,
    )
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    transformer_layers_per_block: int = 1
    attention_head_dim: int = 8  # SD1.5 convention: this is the HEAD COUNT
    cross_attention_dim: int = 768
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    use_linear_projection: bool = False
    conv_in_kernel: int = 3
    conv_out_kernel: int = 3

    @property
    def num_heads(self) -> int:
        # diffusers quirk: for SD1.5 UNets `attention_head_dim` holds the
        # number of heads
        return self.attention_head_dim

    # ---- the BrushNet tap schedule, in consumption order ------------------

    def down_tap_channels(self) -> Tuple[int, ...]:
        """conv_in's output, then per down block one tap after each resnet
        and one after the downsampler (if present)."""
        taps = [self.block_out_channels[0]]
        for i, ch in enumerate(self.block_out_channels):
            taps.extend([ch] * self.layers_per_block)
            if i < len(self.block_out_channels) - 1:
                taps.append(ch)
        return tuple(taps)

    def down_tap_strides(self) -> Tuple[int, ...]:
        """Spatial downscale factor (against the latent) of each down tap."""
        strides, s = [1], 1
        for i in range(len(self.block_out_channels)):
            strides.extend([s] * self.layers_per_block)
            if i < len(self.block_out_channels) - 1:
                s *= 2
                strides.append(s)
        return tuple(strides)

    def mid_tap_channels(self) -> int:
        return self.block_out_channels[-1]

    def up_tap_channels(self) -> Tuple[int, ...]:
        """Per up block one tap after each of its layers_per_block + 1
        resnets and one after the upsampler (if present): 15 for SD1.5."""
        taps = []
        rev = tuple(reversed(self.block_out_channels))
        for i, ch in enumerate(rev):
            taps.extend([ch] * (self.layers_per_block + 1))
            if i < len(rev) - 1:
                taps.append(ch)
        return tuple(taps)

    def up_tap_strides(self) -> Tuple[int, ...]:
        strides, s = [], 2 ** (len(self.block_out_channels) - 1)
        for i in range(len(self.up_block_types)):
            strides.extend([s] * (self.layers_per_block + 1))
            if i < len(self.up_block_types) - 1:
                s //= 2
                strides.append(s)
        return tuple(strides)


@dataclasses.dataclass(frozen=True)
class BrushNetConfig(_ConfigBase):
    """The ppt-v2 side branch: a full UNet (down, mid, up) of ``base``'s
    widths whose input is concat(noisy latent, 5 conditioning channels)
    through ``conv_in_condition``, with one zero-initialised 1x1 conv per
    tap."""

    base: UNetConfig = dataclasses.field(
        default_factory=lambda: UNetConfig(in_channels=4))
    conditioning_channels: int = 5  # masked-image latents (4) + mask (1)

    @classmethod
    def from_dict(cls, d: dict) -> "BrushNetConfig":
        d = dict(d)
        if isinstance(d.get("base"), dict):
            d["base"] = UNetConfig.from_dict(d["base"])
        return super().from_dict.__func__(cls, d)


@dataclasses.dataclass(frozen=True)
class VAEConfig(_ConfigBase):
    """AutoencoderKL (SD1.5)."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    sample_size: int = 512


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig(_ConfigBase):
    """CLIP ViT-L/14 text tower (SD1.5), 768-d."""

    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    # number of extra (task-prompt) token rows appended to the embedding table
    num_external_tokens: int = 0


@dataclasses.dataclass(frozen=True)
class SchedulerConfig(_ConfigBase):
    """Shared diffusion-schedule parameters (SD1.5 scaled-linear betas)."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    prediction_type: str = "epsilon"
    steps_offset: int = 1
    timestep_spacing: str = "leading"
    set_alpha_to_one: bool = False
    # UniPC specifics
    solver_order: int = 2
    lower_order_final: bool = True
    solver_type: str = "bh2"


@dataclasses.dataclass(frozen=True)
class PowerPaintConfig(_ConfigBase):
    """Top-level stack description: ppt-v1, or ppt-v2 when ``brushnet`` is
    set (then ``text_encoder`` describes the task-token tower of the BrushNet
    branch; the base UNet's plain tower is the same with no task rows)."""

    version: str = "ppt-v1"
    unet: UNetConfig = dataclasses.field(default_factory=UNetConfig)
    vae: VAEConfig = dataclasses.field(default_factory=VAEConfig)
    text_encoder: CLIPTextConfig = dataclasses.field(
        default_factory=lambda: CLIPTextConfig(num_external_tokens=30)
    )
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    brushnet: Optional[BrushNetConfig] = None

    @classmethod
    def from_dict(cls, d: dict) -> "PowerPaintConfig":
        d = dict(d)
        for k, sub in (
            ("unet", UNetConfig),
            ("vae", VAEConfig),
            ("text_encoder", CLIPTextConfig),
            ("scheduler", SchedulerConfig),
            ("brushnet", BrushNetConfig),
        ):
            if isinstance(d.get(k), dict):
                d[k] = sub.from_dict(d[k])
        return super().from_dict.__func__(cls, d)


def ppt_v1_config() -> PowerPaintConfig:
    return PowerPaintConfig(version="ppt-v1")


def ppt_v2_config() -> PowerPaintConfig:
    """SD1.5 base UNet with 4 input channels, a BrushNet branch of the same
    widths, the SD1.5 VAE and two CLIP ViT-L/14 text towers."""
    return PowerPaintConfig(version="ppt-v2", unet=UNetConfig(in_channels=4),
                            brushnet=BrushNetConfig())
