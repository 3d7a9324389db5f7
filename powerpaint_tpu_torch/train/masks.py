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
OpenCV, so this module rasterises them itself with OpenCV's integer
algorithms (``drawing.cpp``: ``ThickLine``, ``FillConvexPoly`` in 16.16
fixed point with its edges drawn by ``Line2``, and the midpoint ``Circle``);
the CPU tests hold it to ``cv2`` pixel for pixel. A stroke's ends lie in
the image, as the masks draw them: OpenCV clips a line whose end lies
outside first, which ``draw_line`` does not reproduce, so it refuses one.
"""

from __future__ import annotations

import math

import numpy as np

_SHIFT = 16
_ONE = 1 << _SHIFT


def _tdiv(a: int, b: int) -> int:
    """C integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _hline(m: np.ndarray, y: int, x1: int, x2: int) -> None:
    m[y, x1:x2 + 1] = 1.0


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's ``clipLine`` on a (w, h) box: the clipped ends, or None."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return x1, y1, x2, y2


def _line2(m: np.ndarray, p1, p2) -> None:
    """OpenCV's ``Line2``: an 8-connected line between 16.16 fixed-point
    ends."""
    h, w = m.shape
    clipped = _clip_line(w << _SHIFT, h << _SHIFT, p1[0], p1[1], p2[0], p2[1])
    if clipped is None:
        return
    x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step, y_step = _ONE, _tdiv(dy << _SHIFT, ax | 1)
        ecount = (x2 - x1) >> _SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step, y_step = _tdiv(dx << _SHIFT, ay | 1), _ONE
        ecount = (y2 - y1) >> _SHIFT
    x1 += _ONE >> 1
    y1 += _ONE >> 1
    # the end point first, rounded, then the walk from the start
    x, y = (x2 + (_ONE >> 1)) >> _SHIFT, (y2 + (_ONE >> 1)) >> _SHIFT
    if 0 <= x < w and 0 <= y < h:
        m[y, x] = 1.0
    if ax > ay:
        x1 >>= _SHIFT
        while ecount >= 0:
            x, y = x1, y1 >> _SHIFT
            if 0 <= x < w and 0 <= y < h:
                m[y, x] = 1.0
            x1 += 1
            y1 += y_step
            ecount -= 1
    else:
        y1 >>= _SHIFT
        while ecount >= 0:
            x, y = x1 >> _SHIFT, y1
            if 0 <= x < w and 0 <= y < h:
                m[y, x] = 1.0
            x1 += x_step
            y1 += 1
            ecount -= 1


def _fill_convex_poly(m: np.ndarray, v) -> None:
    """OpenCV's ``FillConvexPoly`` (8-connected, points in 16.16 fixed
    point): the outline by ``Line2``, then scanlines between two edges."""
    h, w = m.shape
    npts = len(v)
    delta = _ONE >> 1
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    p0 = v[-1]
    for i, p in enumerate(v):
        if p[1] < ymin:
            ymin, imin = p[1], i
        ymax, xmax, xmin = max(ymax, p[1]), max(xmax, p[0]), min(xmin, p[0])
        _line2(m, p0, p)
        p0 = p
    xmin, xmax = (xmin + delta) >> _SHIFT, (xmax + delta) >> _SHIFT
    ymin, ymax = (ymin + delta) >> _SHIFT, (ymax + delta) >> _SHIFT
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edges = npts
    # [idx, di, x, dx, ye] for the two edges walked from the top vertex
    edge = [[imin, 1, -_ONE, 0, ymin], [imin, npts - 1, -_ONE, 0, ymin]]
    y = ymin
    while True:
        for e in edge:
            if y >= e[4]:
                idx0, di = e[0], e[1]
                idx = idx0 + di
                if idx >= npts:
                    idx -= npts
                while edges > 0:
                    edges -= 1
                    ty = (v[idx][1] + delta) >> _SHIFT
                    if ty > y:
                        xs, xe = v[idx0][0], v[idx][0]
                        e[4] = ty
                        e[3] = _tdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        e[2] = xs
                        e[0] = idx
                        break
                    idx0 = idx
                    idx += di
                    if idx >= npts:
                        idx -= npts
                else:
                    edges -= 1
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0][2] > edge[1][2] else (0, 1)
            xx1 = (edge[left][2] + delta) >> _SHIFT
            xx2 = (edge[right][2] + delta) >> _SHIFT
            if xx2 >= 0 and xx1 < w:
                _hline(m, y, max(xx1, 0), min(xx2, w - 1))
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            break


def _circle(m: np.ndarray, cx: int, cy: int, radius: int) -> None:
    """OpenCV's filled ``Circle`` (the midpoint algorithm's spans)."""
    h, w = m.shape
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        y11, y12, y21, y22 = cy - dy, cy + dy, cy - dx, cy + dx
        x11, x12, x21, x22 = cx - dx, cx + dx, cx - dy, cx + dy
        if x11 < w and x12 >= 0 and y21 < h and y22 >= 0:
            x11, x12 = max(x11, 0), min(x12, w - 1)
            for yy in (y11, y12):
                if 0 <= yy < h:
                    _hline(m, yy, x11, x12)
            if x21 < w and x22 >= 0:
                x21, x22 = max(x21, 0), min(x22, w - 1)
                for yy in (y21, y22):
                    if 0 <= yy < h:
                        _hline(m, yy, x21, x22)
        dy += 1
        err += plus
        plus += 2
        mask = -1 if err > 0 else 0
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def draw_line(m: np.ndarray, a, b, thickness: int) -> None:
    """``cv2.line(m, a, b, 1.0, thickness)`` for thickness > 1: OpenCV's
    ``ThickLine`` (a quad in 16.16 fixed point and a disc at each end).
    Both ends must lie in the image."""
    h, w = m.shape
    if not all(0 <= p[0] < w and 0 <= p[1] < h for p in (a, b)):
        raise ValueError(f"line ends {tuple(a)}, {tuple(b)} outside a "
                         f"{w} x {h} image")
    p0 = (int(a[0]) << _SHIFT, int(a[1]) << _SHIFT)
    p1 = (int(b[0]) << _SHIFT, int(b[1]) << _SHIFT)
    dx = (p0[0] - p1[0]) / _ONE
    dy = (p1[1] - p0[1]) / _ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    t = thickness << (_SHIFT - 1)
    if abs(r) > 2.220446049250313e-16:
        r = (t + odd * _ONE * 0.5) / math.sqrt(r)
        dpx, dpy = round(dy * r), round(dx * r)
        _fill_convex_poly(m, [(p0[0] + dpx, p0[1] + dpy),
                              (p0[0] - dpx, p0[1] - dpy),
                              (p1[0] - dpx, p1[1] - dpy),
                              (p1[0] + dpx, p1[1] + dpy)])
    radius = (t + (_ONE >> 1)) >> _SHIFT
    for p in (p0, p1):
        _circle(m, (p[0] + (_ONE >> 1)) >> _SHIFT,
                (p[1] + (_ONE >> 1)) >> _SHIFT, radius)


def draw_disc(m: np.ndarray, center, radius: int) -> None:
    """``cv2.circle(m, center, radius, 1.0, -1)``."""
    _circle(m, int(center[0]), int(center[1]), int(radius))


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
