"""Model / pipeline configuration dataclasses.

The port's own copy of the ppt-v1, ppt-v2 and ppt-v1 + ControlNet parts of
``powerpaint_tpu.core.config``:
frozen dataclasses that are the single source of truth for block topology,
with the same field names and defaults, so a config serialized by either
package loads in the other (unknown keys are ignored by ``from_dict``).
Beside them, the annotator, safety-checker and IP-Adapter image-encoder
networks' shapes: ``CLIPVisionConfig`` and ``DPTConfig`` (the JAX package
keeps the latter in ``models/dpt.py``), with ``dpt_config_from_hf_dict``
reading a DPT checkpoint's ``config.json``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional, Tuple, Union


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
    # LCM-distilled UNets condition the time embedding on the guidance
    # scale: the width of that embedding (None: no ``cond_proj``)
    time_cond_proj_dim: Optional[int] = None
    # IP-Adapter: the CLIP image embedding's width (1024 for the SD1.5
    # adapters' OpenCLIP ViT-H tower; 0: no adapter), and the context
    # tokens its projection makes (4 for ip-adapter_sd15): an int for one
    # adapter, or one per adapter of a stack
    ip_adapter_dim: int = 0
    ip_adapter_tokens: Union[int, Tuple[int, ...]] = 4

    @property
    def num_heads(self) -> int:
        # diffusers quirk: for SD1.5 UNets `attention_head_dim` holds the
        # number of heads
        return self.attention_head_dim

    @property
    def ip_adapters(self) -> Tuple[int, ...]:
        """Context tokens of each IP-Adapter the UNet carries (empty when
        ``ip_adapter_dim`` is 0)."""
        if not self.ip_adapter_dim:
            return ()
        t = self.ip_adapter_tokens
        return tuple(t) if isinstance(t, (tuple, list)) else (t,)

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

    def controlnet_residual_channels(self) -> Tuple[int, ...]:
        """Channels of the ControlNet's down residuals, one per skip
        connection: conv_in, each resnet and each downsampler."""
        return self.down_tap_channels()


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
class ControlNetConfig(_ConfigBase):
    """Classic diffusers ControlNet: the down and mid half of ``base``'s
    UNet on the noisy latent, a conditioning embedding on the raw control
    image, and one 1x1 "zero" conv per skip connection and on the mid
    block. ``base`` is the 9-channel inpainting UNet, as in the JAX
    package; the branch's own conv_in sees only the 4-channel latent."""

    base: UNetConfig = dataclasses.field(default_factory=UNetConfig)
    conditioning_channels: int = 3
    conditioning_embedding_out_channels: Tuple[int, ...] = (16, 32, 96, 256)

    @classmethod
    def from_dict(cls, d: dict) -> "ControlNetConfig":
        d = dict(d)
        if isinstance(d.get("base"), dict):
            d["base"] = UNetConfig.from_dict(d["base"])
        return super().from_dict.__func__(cls, d)


@dataclasses.dataclass(frozen=True)
class VAEConfig(_ConfigBase):
    """AutoencoderKL (SD1.5). ``asymmetric``: an AsymmetricAutoencoderKL,
    whose decoder is mask-conditioned (``decode_with_condition``) and may
    have its own widths (``up_block_out_channels``) and depth
    (``layers_per_up_block``); ``condition_layers`` is the (kernel, stride,
    out_ch) spec of its known-region condition tower, as
    ``io.convert.infer_condition_layers`` reads it from a checkpoint."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    sample_size: int = 512
    asymmetric: bool = False
    up_block_out_channels: Optional[Tuple[int, ...]] = None
    layers_per_up_block: Optional[int] = None
    condition_layers: Optional[Tuple[Tuple[int, int, int], ...]] = None

    @property
    def up_channels(self) -> Tuple[int, ...]:
        return self.up_block_out_channels or self.block_out_channels

    @property
    def up_layers(self) -> int:
        return (self.layers_per_up_block if self.layers_per_up_block
                is not None else self.layers_per_block)


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
    # LCM specifics (consistency-model boundary conditions + the coarse
    # training grid LCM-LoRA checkpoints are distilled on)
    original_inference_steps: int = 50
    timestep_scaling: float = 10.0


@dataclasses.dataclass(frozen=True)
class PowerPaintConfig(_ConfigBase):
    """Top-level stack description: ppt-v1, or ppt-v2 when ``brushnet`` is
    set (then ``text_encoder`` describes the task-token tower of the BrushNet
    branch; the base UNet's plain tower is the same with no task rows), or
    ppt-v1 with ControlNet branches when ``controlnet`` is set.
    ``image_encoder``: the CLIP image tower of an IP-Adapter (ppt-v2)."""

    version: str = "ppt-v1"
    unet: UNetConfig = dataclasses.field(default_factory=UNetConfig)
    vae: VAEConfig = dataclasses.field(default_factory=VAEConfig)
    text_encoder: CLIPTextConfig = dataclasses.field(
        default_factory=lambda: CLIPTextConfig(num_external_tokens=30)
    )
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    brushnet: Optional[BrushNetConfig] = None
    controlnet: Optional[ControlNetConfig] = None
    image_encoder: Optional[CLIPVisionConfig] = None

    @classmethod
    def from_dict(cls, d: dict) -> "PowerPaintConfig":
        d = dict(d)
        for k, sub in (
            ("unet", UNetConfig),
            ("vae", VAEConfig),
            ("text_encoder", CLIPTextConfig),
            ("scheduler", SchedulerConfig),
            ("brushnet", BrushNetConfig),
            ("controlnet", ControlNetConfig),
            ("image_encoder", CLIPVisionConfig),
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


def ppt_v1_controlnet_config() -> PowerPaintConfig:
    """ppt-v1 with one SD1.5 ControlNet branch (canny, depth, HED or pose
    weights all share this shape)."""
    return PowerPaintConfig(version="ppt-v1", controlnet=ControlNetConfig())


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig(_ConfigBase):
    """CLIP ViT image tower; the defaults are ViT-L/14 at 224, the safety
    checker's tower. The attribute names are ``CLIPTextConfig``'s, so the
    text tower's encoder layer serves this one too."""

    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    projection_dim: int = 768
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5


@dataclasses.dataclass(frozen=True)
class DPTConfig(_ConfigBase):
    """The fields of HF ``DPTConfig(is_hybrid=True)`` the DPT-hybrid depth
    network's shape depends on; the defaults are Intel/dpt-hybrid-midas."""

    # BiT backbone
    embedding_size: int = 64
    bit_hidden_sizes: Tuple[int, ...] = (256, 512, 1024)
    bit_depths: Tuple[int, ...] = (3, 4, 9)
    bit_num_groups: int = 32
    # ViT encoder
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    layer_norm_eps: float = 1e-12
    image_size: int = 384
    patch_size: int = 16
    # the ViT layers whose outputs feed reassembly stages 3 and 4
    # (0-indexed, HF backbone_out_indices[2:])
    vit_out_layers: Tuple[int, int] = (8, 11)
    # neck and head
    neck_hidden_sizes: Tuple[int, ...] = (256, 512, 768, 768)
    reassemble_factors: Tuple[float, ...] = (1.0, 1.0, 1.0, 0.5)
    fusion_hidden_size: int = 256


def safety_checker_config() -> CLIPVisionConfig:
    """The CompVis safety checker's tower: CLIP ViT-L/14 at 224, projection
    768 (the checker adds 17 concept and 3 special-care rows)."""
    return CLIPVisionConfig()


def vit_h14_image_encoder_config() -> CLIPVisionConfig:
    """The SD1.5 IP-Adapter's image encoder, OpenCLIP ViT-H/14 at 224, as
    its published ``image_encoder/config.json`` gives it: width 1280, 32
    layers of 16 heads (head dim 80), MLP 5120, exact (erf) ``gelu``,
    projection 1024."""
    return CLIPVisionConfig(hidden_size=1280, intermediate_size=5120,
                            num_hidden_layers=32, num_attention_heads=16,
                            projection_dim=1024, hidden_act="gelu")


def dpt_hybrid_midas_config() -> DPTConfig:
    """Intel/dpt-hybrid-midas: BiT (3, 4, 9) + ViT-B/16 at 384."""
    return DPTConfig()


# HF DPTConfig's defaults where a config.json leaves a field out, and
# BitConfig's for the hybrid backbone HF builds when it has none
_HF_DPT_DEFAULTS = dict(hidden_size=768, num_hidden_layers=12,
                        num_attention_heads=12, intermediate_size=3072,
                        layer_norm_eps=1e-12, image_size=384, patch_size=16,
                        backbone_out_indices=(2, 5, 8, 11),
                        neck_hidden_sizes=(96, 192, 384, 768),
                        reassemble_factors=(4, 2, 1, 0.5),
                        fusion_hidden_size=256)
_HF_BIT_DEFAULTS = dict(embedding_size=64, hidden_sizes=(256, 512, 1024, 2048),
                        depths=(3, 4, 9), num_groups=32)


def dpt_config_from_hf_dict(d: dict) -> DPTConfig:
    """A hybrid DPT checkpoint's ``config.json`` (as a dict) -> DPTConfig,
    read with HF's defaults for the fields it leaves out (the port's copy
    of the JAX package's ``io/convert.py::dpt_config_from_hf``, on the
    JSON instead of a ``transformers`` config object)."""
    if not d.get("is_hybrid", False):
        raise ValueError("only the hybrid DPT (is_hybrid=true) is supported")
    get = lambda k: d.get(k, _HF_DPT_DEFAULTS[k])  # noqa: E731
    bit = dict(_HF_BIT_DEFAULTS, **(d.get("backbone_config") or {}))
    depths = tuple(bit["depths"])
    return DPTConfig(
        embedding_size=int(bit["embedding_size"]),
        bit_hidden_sizes=tuple(bit["hidden_sizes"][:len(depths)]),
        bit_depths=depths,
        bit_num_groups=int(bit["num_groups"]),
        hidden_size=get("hidden_size"),
        num_layers=get("num_hidden_layers"),
        num_heads=get("num_attention_heads"),
        intermediate_size=get("intermediate_size"),
        layer_norm_eps=get("layer_norm_eps"),
        image_size=get("image_size"),
        patch_size=get("patch_size"),
        vit_out_layers=tuple(get("backbone_out_indices")[2:]),
        neck_hidden_sizes=tuple(get("neck_hidden_sizes")),
        reassemble_factors=tuple(float(f) for f in get("reassemble_factors")),
        fusion_hidden_size=get("fusion_hidden_size"),
    )
