"""Conditional UNet2D (SD1.5 family: the 9-channel inpainting UNet of ppt-v1,
the 4-channel base UNet of ppt-v2) on NHWC activations, with diffusers
``UNet2DConditionModel`` parameter names, and BrushNet tap and ControlNet
residual injection.

The BrushNet branch's features arrive as flat sequences in consumption
order, sliced per block by the config's tap schedule (``_down_tap_counts``,
``_up_tap_counts``), as in the JAX package: one tap after conv_in (added
AFTER conv_in's skip is recorded), then the down blocks' taps, one after
the mid block, then the up blocks' taps.

The ControlNet branches' residuals (their sum) are added onto every
recorded skip, conv_in's included, after the last down block, and the mid
residual right after the mid block, before any BrushNet mid tap.

Encoder propagation (Faster Diffusion, arXiv 2312.09608), as in the JAX
package: a key step returns the encoder's features (the feature after the
down blocks and every skip) with its output, and a step given them skips
conv_in and the down blocks, recomputing only the mid and up blocks with
its own timestep embedding. ``freeu`` (``ops.freeu.FreeUConfig``, settable
as ``unet.freeu``, None for off) applies FreeU in the up blocks.

IP-Adapter (``ip_adapter_dim`` > 0): one ``ImageProjection`` per adapter
(``encoder_hid_proj.<a>``) turns that adapter's CLIP image embedding into
its context tokens, on every evaluation, as the JAX UNet does; every
cross-attention takes them (``models.transformer``).

T2I-Adapter features (``down_intrablock_additional_residuals``) are taken
in order, as in the JAX package: a cross-attention down block adds its
feature inside, after its last (resnet, attention) pair and before the
skip is recorded; a plain down block adds it to its output after its skips
are recorded; a feature left over after the down blocks whose shape is the
mid block's output joins that output (none is left by an SD1.5 adapter's
four)."""

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
from powerpaint_tpu_torch.models.projection import ImageProjection
from powerpaint_tpu_torch.models.transformer import ImageContext, Scales
from powerpaint_tpu_torch.ops.freeu import FreeUConfig


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


def _attention_args(cfg: UNetConfig, ip_adapters: int) -> dict:
    return dict(num_heads=cfg.num_heads,
                context_dim=cfg.cross_attention_dim,
                transformer_layers=cfg.transformer_layers_per_block,
                use_linear_projection=cfg.use_linear_projection,
                eps=cfg.norm_eps, groups=cfg.norm_num_groups,
                ip_adapters=ip_adapters)


def add_encoder(model: nn.Module, cfg: UNetConfig,
                cond_proj_dim: Optional[int] = None,
                ip_adapters: int = 0) -> None:
    """Give ``model`` the time embedding (with a ``cond_proj`` of
    ``cond_proj_dim`` features when given), down and mid blocks of ``cfg``
    (with ``ip_adapters`` image K/V pairs in each cross-attention): what
    the UNet, the BrushNet branch and the ControlNet branch share."""
    if cfg.mid_block_type != MID_CROSS_ATTN:
        raise ValueError(f"unsupported mid block {cfg.mid_block_type}")
    ch = cfg.block_out_channels
    temb_ch = ch[0] * 4
    attn = _attention_args(cfg, ip_adapters)
    model.time_embedding = TimestepEmbedding(ch[0], temb_ch, cond_proj_dim)

    model.down_blocks = nn.ModuleList()
    for i, kind in enumerate(cfg.down_block_types):
        model.down_blocks.append(DownBlock(
            ch[max(i - 1, 0)], ch[i], temb_ch,
            num_layers=cfg.layers_per_block,
            add_downsample=i < len(ch) - 1,
            cross_attention=kind == CROSS_ATTN_DOWN, **attn))
    model.mid_block = MidBlock(ch[-1], temb_ch, **attn)


def add_blocks(model: nn.Module, cfg: UNetConfig,
               cond_proj_dim: Optional[int] = None,
               ip_adapters: int = 0) -> None:
    """``add_encoder``, then the up blocks: what the UNet and the BrushNet
    branch share."""
    add_encoder(model, cfg, cond_proj_dim, ip_adapters)
    ch = cfg.block_out_channels
    temb_ch = ch[0] * 4
    attn = _attention_args(cfg, ip_adapters)
    rev = tuple(reversed(ch))
    model.up_blocks = nn.ModuleList()
    for i, kind in enumerate(cfg.up_block_types):
        model.up_blocks.append(UpBlock(
            rev[max(i - 1, 0)], rev[i], rev[min(i + 1, len(ch) - 1)],
            temb_ch, num_layers=cfg.layers_per_block + 1,
            add_upsample=i < len(ch) - 1,
            cross_attention=kind == CROSS_ATTN_UP, resolution_idx=i, **attn))


def embed_time(time_embedding: TimestepEmbedding, cfg: UNetConfig,
               timesteps, batch: int, device, dtype: torch.dtype,
               condition: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sinusoid of () or (B,) timesteps, then the embedding MLP (with the
    ``condition`` projected in, for an LCM UNet)."""
    timesteps = torch.as_tensor(timesteps, device=device)
    if timesteps.dim() == 0:
        timesteps = timesteps.expand(batch)
    t_emb = timestep_sinusoid(
        timesteps, cfg.block_out_channels[0],
        flip_sin_to_cos=cfg.flip_sin_to_cos,
        downscale_freq_shift=cfg.freq_shift).to(dtype)
    return time_embedding(t_emb, condition)


class UNet2DConditionModel(nn.Module):
    def __init__(self, config: UNetConfig, freeu: Optional[FreeUConfig] = None):
        super().__init__()
        self.config = cfg = config
        self.freeu = freeu
        ch = cfg.block_out_channels
        self.conv_in = Conv2D(cfg.in_channels, ch[0], cfg.conv_in_kernel,
                              padding=(cfg.conv_in_kernel - 1) // 2)
        add_blocks(self, cfg, cfg.time_cond_proj_dim, len(cfg.ip_adapters))
        if cfg.ip_adapters:
            self.encoder_hid_proj = nn.ModuleList([
                ImageProjection(cfg.ip_adapter_dim, cfg.cross_attention_dim, t)
                for t in cfg.ip_adapters])
        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, ch[0], cfg.norm_eps)
        self.conv_out = Conv2D(ch[0], cfg.out_channels, cfg.conv_out_kernel,
                               padding=(cfg.conv_out_kernel - 1) // 2)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor, *,
                down_block_add_samples: Optional[Sequence[torch.Tensor]] = None,
                mid_block_add_sample: Optional[torch.Tensor] = None,
                up_block_add_samples: Optional[Sequence[torch.Tensor]] = None,
                down_block_additional_residuals: Optional[
                    Sequence[torch.Tensor]] = None,
                mid_block_additional_residual: Optional[torch.Tensor] = None,
                down_intrablock_additional_residuals: Optional[
                    Sequence[torch.Tensor]] = None,
                timestep_cond: Optional[torch.Tensor] = None,
                image_embeds: ImageContext = None,
                ip_scale: Scales = 1.0,
                emit_encoder_cache: bool = False,
                encoder_cache: Optional[tuple] = None):
        """sample (B, H, W, C_in), timesteps () or (B,), encoder_hidden_states
        (B, 77, D) -> (B, H, W, C_out) in the compute dtype. The BrushNet
        taps, when given: 1 + sum(_down_tap_counts) down, one mid,
        sum(_up_tap_counts) up. The ControlNet residuals, when given: one
        per skip (``controlnet_residual_channels``) and one mid.
        ``timestep_cond`` (B, time_cond_proj_dim): the guidance embedding
        of an LCM UNet (``layers.guidance_scale_embedding``).
        ``down_intrablock_additional_residuals``: T2I-Adapter features, one
        per down block (``models.adapter``). ``image_embeds``: the CLIP
        image embedding (B, ip_adapter_dim) of the first adapter, or a list
        of them, one per adapter from the first; ``ip_scale`` a float or
        one per adapter.

        ``emit_encoder_cache``: return (output, (x, skips)), the encoder's
        features; ``encoder_cache``: such features of an earlier step, in
        place of conv_in and the down blocks (``sample`` is then unread).
        Neither goes with BrushNet taps, ControlNet residuals or T2I
        features, which the skipped encoder would have to take in."""
        cfg = self.config
        if (emit_encoder_cache or encoder_cache is not None) and (
                down_block_add_samples is not None
                or down_block_additional_residuals is not None
                or down_intrablock_additional_residuals is not None):
            raise ValueError("encoder caching cannot skip injected down features")
        dtype = self.conv_in.weight.dtype
        temb = embed_time(self.time_embedding, cfg, timesteps, sample.shape[0],
                          sample.device, dtype, timestep_cond)
        context = encoder_hidden_states.to(dtype)
        ip_context = self.image_context(image_embeds)
        feats = (list(down_intrablock_additional_residuals)
                 if down_intrablock_additional_residuals is not None else [])

        if encoder_cache is not None:
            x = encoder_cache[0].to(dtype)
            skips = [s.to(dtype) for s in encoder_cache[1]]
        else:
            x, skips = self._encode(sample.to(dtype), temb, context,
                                    down_block_add_samples,
                                    down_block_additional_residuals,
                                    ip_context, ip_scale, feats)
        cache = (x, tuple(skips)) if emit_encoder_cache else None

        x = self.mid_block(x, temb, context, ip_context, ip_scale)
        if feats and feats[0].shape == x.shape:
            x = x + feats.pop(0)
        if mid_block_additional_residual is not None:
            x = x + mid_block_additional_residual
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
            x, _ = block(x, temb, block_skips, context, output_size, taps,
                         freeu=self.freeu, ip_context=ip_context,
                         ip_scale=ip_scale)

        out = self.conv_out(self.conv_norm_out(x, silu=True))
        return (out, cache) if emit_encoder_cache else out

    def image_context(self, image_embeds: ImageContext) -> ImageContext:
        """The IP-Adapter context tokens of ``image_embeds`` (a tensor: the
        first adapter's; a list: one per adapter from the first), in the
        same form, or None."""
        if image_embeds is None:
            return None
        many = isinstance(image_embeds, (tuple, list))
        embeds = list(image_embeds) if many else [image_embeds]
        projections = getattr(self, "encoder_hid_proj", ())
        if len(embeds) > len(projections):
            raise ValueError(f"{len(embeds)} image embeddings for "
                             f"{len(projections)} IP-Adapters "
                             "(config.unet.ip_adapter_dim / ip_adapter_tokens)")
        out = [proj(e) for proj, e in zip(projections, embeds)]
        return out if many else out[0]

    def _encode(self, x: torch.Tensor, temb: torch.Tensor,
                context: torch.Tensor, down_block_add_samples,
                down_block_additional_residuals,
                ip_context: ImageContext = None, ip_scale: Scales = 1.0,
                feats: Optional[list] = None):
        """conv_in and the down blocks (with the BrushNet taps, the
        ControlNet residuals, the image context and the T2I features,
        which it takes from the front of ``feats``) -> (x, skips)."""
        x = self.conv_in(x)
        skips = [x]
        down_taps = None
        if down_block_add_samples is not None:
            down_taps = list(down_block_add_samples)
            x = x + down_taps.pop(0)
        feats = feats if feats is not None else []
        for block, n in zip(self.down_blocks, _down_tap_counts(self.config)):
            taps = None
            if down_taps is not None:
                taps, down_taps = down_taps[:n], down_taps[n:]
            inside = block.attentions is not None and feats
            x, block_skips = block(x, temb, context, taps, ip_context,
                                   ip_scale,
                                   feats.pop(0) if inside else None)
            skips.extend(block_skips)
            if block.attentions is None and feats:
                x = x + feats.pop(0)
        if down_block_additional_residuals is not None:
            if len(down_block_additional_residuals) != len(skips):
                raise ValueError(
                    f"{len(down_block_additional_residuals)} ControlNet "
                    f"residuals for {len(skips)} skip connections")
            skips = [s + r for s, r in zip(skips,
                                           down_block_additional_residuals)]
        return x, skips
