"""Host-side image/mask preparation and task geometry.

Ports the BEHAVIOR of the reference's preprocessing (numpy/PIL, not torch):

- ``prepare_mask_and_masked_image`` (pipeline_PowerPaint.py:39-153): image ->
  [-1,1] fp32, mask binarized at 0.5, masked_image = image * (mask < 0.5);
- aspect-preserving resize to a target short side + crop to %8
  (app.py:258-269, 317-321);
- outpainting canvas expansion onto gray(127) with a 10px blurry-gap border
  mask (app.py:271-307) — converts outpainting into inpainting;
- ppt-v2 pre-masking ``img * (1 - mask)`` (app.py:342-345).

Everything returns NHWC numpy; pipelines move data to device once.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _pil_image():
    """PIL's Image module, or None where PIL is not installed (PIL stays
    off the import path: the GPU host may not have it)."""
    try:
        from PIL import Image
    except ImportError:  # pragma: no cover
        return None
    return Image


def to_numpy_image(image) -> np.ndarray:
    """PIL / array -> (H, W, 3) uint8."""
    Image = _pil_image()
    if Image is not None and isinstance(image, Image.Image):
        return np.asarray(image.convert("RGB"))
    arr = np.asarray(image)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    return arr


def to_numpy_mask(mask) -> np.ndarray:
    """PIL / array -> (H, W) float in [0,1]; 1 = hole to inpaint."""
    Image = _pil_image()
    if Image is not None and isinstance(mask, Image.Image):
        arr = np.asarray(mask.convert("L")).astype(np.float32) / 255.0
    else:
        arr = np.asarray(mask).astype(np.float32)
        if arr.ndim == 3:
            arr = arr.mean(axis=-1)
        if arr.max() > 1.0:
            arr = arr / 255.0
    return arr


def resize_short_side(
    img: np.ndarray, target: int, resample=None
) -> np.ndarray:
    """Aspect-preserving resize so the SHORT side == target (app.py:261-269)."""
    h, w = img.shape[:2]
    if w < h:
        new_w = target
        new_h = int(h * target / w)
    else:
        new_h = target
        new_w = int(w * target / h)
    Image = _pil_image()
    if Image is not None:
        mode = "L" if img.ndim == 2 else "RGB"
        src = img if img.dtype == np.uint8 else (np.clip(img, 0, 1) * 255).astype(np.uint8)
        pil = Image.fromarray(src, mode=mode)
        out = np.asarray(pil.resize((new_w, new_h)))
        if img.dtype != np.uint8:
            out = out.astype(np.float32) / 255.0
        return out
    # nearest fallback
    yi = (np.arange(new_h) * h / new_h).astype(int)
    xi = (np.arange(new_w) * w / new_w).astype(int)
    return img[yi][:, xi]


def bucket_size(n: int, multiple: int = 64, max_size: int = 2048) -> int:
    """Round up to the next size bucket (multiples of 64 pixels), so a
    server sees a few dozen distinct shapes over the practical range."""
    return min(max(((n + multiple - 1) // multiple) * multiple, multiple),
               max_size)


def pad_to_bucket(
    image: np.ndarray, mask: np.ndarray, multiple: int = 64
):
    """Pad (image, mask) to the next size bucket with edge-replicated
    pixels marked KEEP (mask 0) — generation preserves them and
    ``crop_from_bucket`` removes them, so results match the unpadded
    request wherever the model is translation-consistent.

    Returns (image_p, mask_p, (orig_h, orig_w))."""
    h, w = image.shape[:2]
    bh, bw = bucket_size(h, multiple), bucket_size(w, multiple)
    if (bh, bw) == (h, w):
        return image, mask, (h, w)
    image_p = np.pad(image, ((0, bh - h), (0, bw - w), (0, 0)), mode="edge")
    mask_p = np.pad(mask, ((0, bh - h), (0, bw - w)), mode="constant",
                    constant_values=0.0)
    return image_p, mask_p, (h, w)


def crop_from_bucket(out: np.ndarray, orig_hw) -> np.ndarray:
    """Crop a (B, H, W, C) or (H, W, C) result back to the pre-bucket size."""
    h, w = orig_hw
    return out[..., :h, :w, :] if out.ndim == 4 else out[:h, :w]


def crop_to_multiple_of_8(img: np.ndarray) -> np.ndarray:
    h, w = img.shape[:2]
    return img[: h - h % 8, : w - w % 8]


def round_down_8(x: int) -> int:
    return x - x % 8


def outpaint_canvas(
    image: np.ndarray,
    horizontal_expansion_ratio: float,
    vertical_expansion_ratio: float,
    blurry_gap: int = 10,
) -> Tuple[np.ndarray, np.ndarray]:
    """Expand onto gray(127) canvas; border mask with a blurry-gap overlap
    into the original image (app.py:271-307).  Returns (image, mask01)."""
    o_h, o_w = image.shape[:2]
    c_h = int(vertical_expansion_ratio * o_h)
    c_w = int(horizontal_expansion_ratio * o_w)
    expand_img = np.ones((c_h, c_w, 3), dtype=np.uint8) * 127
    y0 = int((c_h - o_h) / 2.0)
    x0 = int((c_w - o_w) / 2.0)
    expand_img[y0 : y0 + o_h, x0 : x0 + o_w] = image

    expand_mask = np.ones((c_h, c_w), dtype=np.float32)
    # keep-region (mask=0) shrinks into the original by blurry_gap on the
    # expanded sides only (app.py:283-304 handles each ratio case)
    gy = blurry_gap if vertical_expansion_ratio != 1.0 else 0
    gx = blurry_gap if horizontal_expansion_ratio != 1.0 else 0
    expand_mask[y0 + gy : y0 + o_h - gy, x0 + gx : x0 + o_w - gx] = 0.0
    return expand_img, expand_mask


def prepare_inpaint_inputs(
    image: np.ndarray, mask: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(image01u8 HxWx3, mask01 HxW) -> (init [-1,1], mask {0,1}, masked).

    Matches prepare_mask_and_masked_image (pipeline_PowerPaint.py:39-153):
    mask < 0.5 -> 0 else 1; masked = init * (mask < 0.5). NHWC fp32.
    """
    init = image.astype(np.float32) / 127.5 - 1.0
    m = (mask >= 0.5).astype(np.float32)[..., None]
    masked = init * (1.0 - m)
    return init[None], m[None], masked[None]


def premask_image_v2(image: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """ppt-v2 zeroes the hole in PIXEL space before VAE encode
    (app.py:342-345)."""
    m = (mask >= 0.5).astype(np.float32)[..., None]
    return (image.astype(np.float32) * (1.0 - m)).astype(np.uint8)


def resize_to(image: np.ndarray, mask, height: int, width: int):
    """Resize an image (and optionally its mask) to an exact (height,
    width) — the reference pipelines' ``height``/``width`` call arguments
    (pipeline_PowerPaint.py:729-730, resolved via the diffusers image
    processor).  LANCZOS for the image, NEAREST for the {0,1} mask.
    Both dimensions must be multiples of 8 (latent grid)."""
    from PIL import Image

    if height % 8 or width % 8:
        from powerpaint_tpu_torch.core.validation import InputValidationError

        raise InputValidationError(
            f"height/width must be multiples of 8, got {height}x{width}"
        )
    img = np.asarray(
        Image.fromarray(image).resize((width, height), Image.LANCZOS)
    )
    if mask is None:
        return img, None
    m = np.asarray(
        Image.fromarray((np.asarray(mask) * 255).astype(np.uint8)).resize(
            (width, height), Image.NEAREST
        )
    ).astype(np.float32) / 255.0
    return img, m
