"""ctypes binding for the host image ops of ``native/image_ops.cpp`` (the
port of ``powerpaint_tpu/tasks/native.py``): Gaussian mask blur, blend
compositing, red overlay.

The library is built from the repository's ``native/image_ops.cpp`` into
the port's ``_build/`` at first use (``ops._build.load_native``), with
``native/build.sh``'s flags. There is no fallback: if it cannot be built,
the call raises with the compiler's output. The numpy versions in
``tasks/postprocess.py`` are the plain versions a caller asks for by name.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from powerpaint_tpu_torch.ops._build import load_native

    lib = load_native("image")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.ppt_gaussian_blur.argtypes = [f32p, ctypes.c_int32, ctypes.c_int32,
                                      ctypes.c_float]
    lib.ppt_blend.argtypes = [u8p, u8p, f32p, ctypes.c_int32, ctypes.c_int32,
                              u8p]
    lib.ppt_red_overlay.argtypes = [u8p, f32p, ctypes.c_int32, ctypes.c_int32,
                                    ctypes.c_float, u8p]
    return lib


def gaussian_blur(mask: np.ndarray, radius: float) -> np.ndarray:
    """Separable Gaussian blur of a (H, W) float mask, edge-clamped."""
    out = np.ascontiguousarray(mask, dtype=np.float32).copy()
    _lib().ppt_gaussian_blur(out, out.shape[0], out.shape[1], float(radius))
    return out


def blend_result(result: np.ndarray, original: np.ndarray, mask: np.ndarray,
                 blur_radius: float = 4.0) -> np.ndarray:
    """out = result * m + original * (1 - m), m the blurred mask clamped to
    [0, 1], rounded to uint8."""
    m = gaussian_blur(mask, blur_radius)
    h, w = m.shape
    out = np.empty((h, w, 3), np.uint8)
    _lib().ppt_blend(np.ascontiguousarray(result, np.uint8),
                     np.ascontiguousarray(original, np.uint8), m, h, w, out)
    return out


def red_overlay(image: np.ndarray, mask: np.ndarray,
                alpha: float = 0.5) -> np.ndarray:
    """Blend red into the pixels where ``mask`` >= 0.5, rounded to uint8."""
    h, w = mask.shape
    out = np.empty((h, w, 3), np.uint8)
    _lib().ppt_red_overlay(np.ascontiguousarray(image, np.uint8),
                           np.ascontiguousarray(mask, np.float32), h, w,
                           float(alpha), out)
    return out
