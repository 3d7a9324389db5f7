"""Random inpainting-mask generation (host-side numpy).

The PowerPaint recipe trains each task-prompt group on a different mask
distribution (arXiv 2312.03594 §4): P_obj on object-shaped masks, P_ctxt on
random brush/rectangle masks, P_shape on (dilated) object masks, and
outpainting on border bands. Without segmentation labels the standard
stand-ins are random brush strokes + rectangles (the BrushNet/LaMa
convention); ``random_mask`` samples over those plus border bands.

All masks are float32 (H, W) with 1.0 = region to repaint (the app.py
mask convention), drawn from a ``np.random.RandomState`` in the JAX
package's order of draws, so a seed gives the same masks bit for bit.

The brush strokes are OpenCV's ``cv2.line`` (thickness > 1, 8-connected)
and filled ``cv2.circle``, which the JAX package calls. The GPU host has no
OpenCV, so ``tasks.drawing`` draws them with OpenCV's integer algorithms
written out (``drawing.cpp``: ``ThickLine``, ``FillConvexPoly`` in 16.16
fixed point with its edges drawn by ``Line2``, and the midpoint ``Circle``);
the CPU tests hold them to ``cv2`` pixel for pixel. A stroke's ends lie in
the image, as the masks draw them: OpenCV clips a line whose end lies
outside first, which ``draw_line`` does not reproduce, so it refuses one.
"""

from __future__ import annotations

import numpy as np

from powerpaint_tpu_torch.tasks import drawing


def draw_line(m: np.ndarray, a, b, thickness: int) -> None:
    """``cv2.line(m, a, b, 1.0, thickness)`` for thickness > 1 (OpenCV's
    ``ThickLine``). Both ends must lie in the image."""
    drawing.thick_line(m, a, b, thickness, 1.0)


def draw_disc(m: np.ndarray, center, radius: int) -> None:
    """``cv2.circle(m, center, radius, 1.0, -1)``."""
    drawing.circle(m, center, radius, 1.0)


def random_brush_mask(
    rng: np.random.RandomState, h: int, w: int,
    max_strokes: int = 4,
) -> np.ndarray:
    m = np.zeros((h, w), np.float32)
    for _ in range(rng.randint(1, max_strokes + 1)):
        n_pts = rng.randint(3, 9)
        pts = np.stack([
            rng.randint(0, w, n_pts), rng.randint(0, h, n_pts)
        ], axis=1)
        width = rng.randint(max(3, min(h, w) // 16), max(4, min(h, w) // 4))
        for a, b in zip(pts[:-1], pts[1:]):
            draw_line(m, a, b, width)
            draw_disc(m, b, width // 2)
    return m


def random_rect_mask(
    rng: np.random.RandomState, h: int, w: int, max_rects: int = 3
) -> np.ndarray:
    m = np.zeros((h, w), np.float32)
    for _ in range(rng.randint(1, max_rects + 1)):
        rh = rng.randint(h // 8, h // 2 + 1)
        rw = rng.randint(w // 8, w // 2 + 1)
        y = rng.randint(0, h - rh + 1)
        x = rng.randint(0, w - rw + 1)
        m[y:y + rh, x:x + rw] = 1.0
    return m


def random_border_mask(rng: np.random.RandomState, h: int, w: int
                       ) -> np.ndarray:
    """Outpainting band: repaint everything outside a random inner window
    (the canvas-expansion mask of app.py:271-307 seen from the model)."""
    m = np.ones((h, w), np.float32)
    ih = rng.randint(h // 2, h * 7 // 8)
    iw = rng.randint(w // 2, w * 7 // 8)
    y = rng.randint(0, h - ih + 1)
    x = rng.randint(0, w - iw + 1)
    m[y:y + ih, x:x + iw] = 0.0
    return m


def random_mask(rng: np.random.RandomState, h: int, w: int,
                kind: str | None = None) -> np.ndarray:
    """Sample a training mask; ``kind`` forces brush/rect/border/mix."""
    if kind is None:
        kind = rng.choice(["brush", "rect", "border", "mix"])
    if kind == "brush":
        m = random_brush_mask(rng, h, w)
    elif kind == "rect":
        m = random_rect_mask(rng, h, w)
    elif kind == "border":
        m = random_border_mask(rng, h, w)
    elif kind == "mix":
        m = np.clip(
            random_brush_mask(rng, h, w) + random_rect_mask(rng, h, w),
            0.0, 1.0,
        )
    else:
        raise ValueError(kind)
    if m.sum() == 0:  # degenerate draw: fall back to a centered box
        m[h // 4: 3 * h // 4, w // 4: 3 * w // 4] = 1.0
    return m
