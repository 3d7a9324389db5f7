"""Host-side result compositing / visualization.

Ports the behavior of reference app.py:365-387: Gaussian-blur the mask and
pixel-composite ``out = result*m + input*(1-m)``, plus the red-overlay mask
visualization for galleries.

``blend_result`` composites through the C++ native (``tasks/native.py``,
built from ``native/image_ops.cpp``), as the JAX package does where its
native is built; ``blend_result_plain`` is its numpy version, which runs
only when asked for by name. ``gaussian_blur`` and ``red_overlay`` are
numpy, as the JAX package's are.
"""

from __future__ import annotations

import numpy as np


def gaussian_blur(mask: np.ndarray, radius: float) -> np.ndarray:
    """Separable Gaussian blur of a (H, W) float mask (PIL GaussianBlur
    semantics: sigma ~ radius)."""
    if radius <= 0:
        return mask
    sigma = float(radius)
    half = max(1, int(3 * sigma))
    x = np.arange(-half, half + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    out = np.apply_along_axis(
        lambda r: np.convolve(np.pad(r, half, mode="edge"), k, mode="valid"),
        0, mask.astype(np.float32),
    )
    out = np.apply_along_axis(
        lambda r: np.convolve(np.pad(r, half, mode="edge"), k, mode="valid"),
        1, out,
    )
    return out


def blend_result(
    result: np.ndarray, original: np.ndarray, mask: np.ndarray,
    blur_radius: float = 4.0,
) -> np.ndarray:
    """out = result*m_blur + original*(1-m_blur) — app.py:371-381, through
    the C++ native (rounded to the nearest uint8 level).

    result/original: (H, W, 3) uint8; mask: (H, W) in [0,1]."""
    from powerpaint_tpu_torch.tasks import native

    return native.blend_result(result, original, mask, blur_radius)


def blend_result_plain(
    result: np.ndarray, original: np.ndarray, mask: np.ndarray,
    blur_radius: float = 4.0,
) -> np.ndarray:
    """``blend_result`` in numpy (truncated to uint8): the plain version."""
    m = gaussian_blur(mask, blur_radius)[..., None]
    out = result.astype(np.float32) * m + original.astype(np.float32) * (1 - m)
    return np.clip(out, 0, 255).astype(np.uint8)


def red_overlay(image: np.ndarray, mask: np.ndarray, alpha: float = 0.5):
    """Mask visualization: blend red into masked pixels (app.py:365-370)."""
    out = image.astype(np.float32).copy()
    m = (mask >= 0.5).astype(np.float32)[..., None]
    red = np.zeros_like(out)
    red[..., 0] = 255.0
    out = out * (1 - m * alpha) + red * (m * alpha)
    return np.clip(out, 0, 255).astype(np.uint8)


def latents_image_to_uint8(img: np.ndarray) -> np.ndarray:
    """VAE decoder output [-1,1] (B,H,W,3) -> uint8."""
    img = np.clip(img.astype(np.float32) / 2 + 0.5, 0, 1)
    return (img * 255).round().astype(np.uint8)
