"""What the ppt-v1 and ppt-v2 pipelines share: the int8 option, request
batching and seeds on the host, per-image noise, the VAE sample and the
decode."""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from powerpaint_tpu_torch.core.validation import check_image_mask
from powerpaint_tpu_torch.tasks.preprocess import to_numpy_image, to_numpy_mask


def int8_x_scale(int8: Optional[bool]) -> Optional[float]:
    """The static activation scale of the int8 W8A8 path, or None when it
    is off: the one place the port reads the option. ``int8=None`` reads the
    JAX package's environment: ``POWERPAINT_INT8`` exactly "1" turns it on,
    and the scale is ``POWERPAINT_INT8_XSCALE`` (default 8.0, the post-SiLU
    range it calibrates) over 127."""
    if int8 is None:
        int8 = os.environ.get("POWERPAINT_INT8", "0") == "1"
    if not int8:
        return None
    return float(os.environ.get("POWERPAINT_INT8_XSCALE", "8.0")) / 127.0


def as_list(value, n: int) -> list:
    return list(value) if isinstance(value, (list, tuple)) else [value] * n


def batch_inputs(image, mask, multi: bool,
                 n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(B, H, W, 3) uint8 images and (B, H, W, 1) uint8 masks (255 in the
    hole): B stacked pairs for a batched request that brings them, else
    one pair tiled ``n`` times."""
    if multi and np.asarray(image).ndim == 4:
        img_b = np.stack([to_numpy_image(im) for im in image])
        masks = [to_numpy_mask(m) for m in mask]
        for im, m in zip(img_b, masks):
            check_image_mask(im, m)
        mask_b = np.stack([(m >= 0.5).astype(np.uint8)[..., None] * 255
                           for m in masks])
        return img_b, mask_b
    img = to_numpy_image(image)
    msk = to_numpy_mask(mask)
    check_image_mask(img, msk)
    img_b = np.tile(img[None], (n, 1, 1, 1))
    mask_b = np.tile((msk >= 0.5).astype(np.uint8)[None, ..., None] * 255,
                     (n, 1, 1, 1))
    return img_b, mask_b


def resolve_seeds(seed, b: int) -> List[int]:
    """One seed per image: a list as given, or an int and the ones after
    it (one request, several images)."""
    if isinstance(seed, (list, tuple)):
        seeds = [int(s) for s in seed]
    else:
        seeds = [int(seed) + i for i in range(b)]
    if len(seeds) != b:
        raise ValueError(f"{len(seeds)} seeds for {b} images")
    return seeds


def draw_noise(device, seeds: Sequence[int], shape,
               count: int) -> List[torch.Tensor]:
    """``count`` standard-normal draws of ``shape`` from each image's own
    generator, in order, stacked over the images: a batched request
    reproduces each standalone result."""
    per_image = []
    for seed in seeds:
        g = torch.Generator(device=device).manual_seed(int(seed))
        per_image.append([torch.randn(shape, generator=g, device=device)
                          for _ in range(count)])
    return [torch.stack(d) for d in zip(*per_image)]


def vae_sample(vae, images: torch.Tensor, noise: torch.Tensor,
               scaling_factor: float) -> torch.Tensor:
    """Encode and draw one scaled latent sample per image."""
    mean, logvar = vae.encode(images)
    std = torch.exp(0.5 * logvar.float())
    return (mean.float() + std * noise) * scaling_factor


def to_output(image: torch.Tensor, output_type: str) -> torch.Tensor:
    """A decoded image in [-1, 1] as uint8 or fp32."""
    if output_type == "uint8":
        img01 = torch.clamp(image.float() / 2 + 0.5, 0.0, 1.0)
        return torch.round(img01 * 255.0).to(torch.uint8)
    return image.float()
