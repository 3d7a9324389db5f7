"""OpenCV's rasterisers, written out (``imgproc/src/drawing.cpp``): the
8-connected ``Line`` of ``LineIterator`` and the fixed-point ``Line2``,
``FillConvexPoly``, the midpoint ``Circle``, ``ThickLine`` and
``ellipse2Poly`` with OpenCV's table of degree sines.

The JAX package draws its training masks' brush strokes and the pose
skeleton with ``cv2``; the GPU host has no OpenCV, so the port draws them
here, with OpenCV's integer algorithms, on numpy canvases: (H, W) with a
scalar colour, or (H, W, 3) with one value per channel.
``tests/test_torch_imgproc.py`` and ``tests/test_torch_train.py`` hold them
to ``cv2`` pixel for pixel, lines and polygons that leave the canvas
included.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT

# OpenCV's SinTable: sin of 0..450 degrees, 7 decimals, as fp32
_SIN_TABLE = np.array([round(math.sin(math.radians(a)), 7) for a in range(451)],
                      np.float32)


def _tdiv(a: int, b: int) -> int:
    """C integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _hline(img: np.ndarray, y: int, x1: int, x2: int, color) -> None:
    img[y, x1:x2 + 1] = color


def clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
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


def line(img: np.ndarray, p1, p2, color) -> None:
    """OpenCV's ``Line``: the 8-connected ``LineIterator`` walk between two
    integer points, clipped to the canvas first, drawn left to right."""
    h, w = img.shape[:2]
    x1, y1, x2, y2 = int(p1[0]), int(p1[1]), int(p2[0]), int(p2[1])
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        clipped = clip_line(w, h, x1, y1, x2, y2)
        if clipped is None:
            return
        x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:  # leftToRight
        dx, dy = -dx, -dy
        x1, y1, x2, y2 = x2, y2, x1, y1
    sy = 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - (dy + dy)
    plus, minus = dx + dx, -(dy + dy)
    x, y = x1, y1
    for _ in range(dx + 1):
        img[y, x] = color
        step = err < 0
        err += minus + (plus if step else 0)
        # the major axis always advances, the minor one when err was < 0
        if vert:
            y += sy
            x += 1 if step else 0
        else:
            x += 1
            y += sy if step else 0


def line2(img: np.ndarray, p1, p2, color) -> None:
    """OpenCV's ``Line2``: an 8-connected line between 16.16 fixed-point
    ends."""
    h, w = img.shape[:2]
    clipped = clip_line(w << XY_SHIFT, h << XY_SHIFT, p1[0], p1[1], p2[0], p2[1])
    if clipped is None:
        return
    x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step, y_step = XY_ONE, _tdiv(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step, y_step = _tdiv(dx << XY_SHIFT, ay | 1), XY_ONE
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1
    # the end point first, rounded, then the walk from the start
    x, y = (x2 + (XY_ONE >> 1)) >> XY_SHIFT, (y2 + (XY_ONE >> 1)) >> XY_SHIFT
    if 0 <= x < w and 0 <= y < h:
        img[y, x] = color
    if ax > ay:
        x1 >>= XY_SHIFT
        while ecount >= 0:
            x, y = x1, y1 >> XY_SHIFT
            if 0 <= x < w and 0 <= y < h:
                img[y, x] = color
            x1 += 1
            y1 += y_step
            ecount -= 1
    else:
        y1 >>= XY_SHIFT
        while ecount >= 0:
            x, y = x1 >> XY_SHIFT, y1
            if 0 <= x < w and 0 <= y < h:
                img[y, x] = color
            x1 += x_step
            y1 += 1
            ecount -= 1


def fill_convex_poly(img: np.ndarray, pts, color, shift: int = 0) -> None:
    """OpenCV's ``FillConvexPoly`` (8-connected): the outline (``line``
    for integer points, ``line2`` for fixed-point ones), then scanlines
    between two edges walked down from the top vertex, clipped to the
    canvas. ``shift``: the points' fractional bits (0 or ``XY_SHIFT``)."""
    h, w = img.shape[:2]
    v = [(int(p[0]), int(p[1])) for p in pts]
    npts = len(v)
    if npts == 0:
        return
    delta = (1 << shift) >> 1
    up = XY_SHIFT - shift
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    p0 = (v[-1][0] << up, v[-1][1] << up)
    for i, (px, py) in enumerate(v):
        if py < ymin:
            ymin, imin = py, i
        ymax, xmax, xmin = max(ymax, py), max(xmax, px), min(xmin, px)
        p = (px << up, py << up)
        if shift == 0:
            line(img, (p0[0] >> XY_SHIFT, p0[1] >> XY_SHIFT),
                 (p[0] >> XY_SHIFT, p[1] >> XY_SHIFT), color)
        else:
            line2(img, p0, p, color)
        p0 = p
    xmin, xmax = (xmin + delta) >> shift, (xmax + delta) >> shift
    ymin, ymax = (ymin + delta) >> shift, (ymax + delta) >> shift
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edges = npts
    half = XY_ONE >> 1
    # [idx, di, x, dx, ye] for the two edges walked from the top vertex
    edge = [[imin, 1, -XY_ONE, 0, ymin], [imin, npts - 1, -XY_ONE, 0, ymin]]
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
                    ty = (v[idx][1] + delta) >> shift
                    if ty > y:
                        xs, xe = v[idx0][0] << up, v[idx][0] << up
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
            xx1 = (edge[left][2] + half) >> XY_SHIFT
            xx2 = (edge[right][2] + half) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                _hline(img, y, max(xx1, 0), min(xx2, w - 1), color)
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            break


def circle(img: np.ndarray, center, radius: int, color) -> None:
    """OpenCV's filled ``Circle`` (``cv2.circle(img, center, radius, color,
    -1)``): the midpoint algorithm's spans."""
    h, w = img.shape[:2]
    cx, cy, radius = int(center[0]), int(center[1]), int(radius)
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        y11, y12, y21, y22 = cy - dy, cy + dy, cy - dx, cy + dx
        x11, x12, x21, x22 = cx - dx, cx + dx, cx - dy, cx + dy
        if x11 < w and x12 >= 0 and y21 < h and y22 >= 0:
            x11, x12 = max(x11, 0), min(x12, w - 1)
            for yy in (y11, y12):
                if 0 <= yy < h:
                    _hline(img, yy, x11, x12, color)
            if x21 < w and x22 >= 0:
                x21, x22 = max(x21, 0), min(x22, w - 1)
                for yy in (y21, y22):
                    if 0 <= yy < h:
                        _hline(img, yy, x21, x22, color)
        dy += 1
        err += plus
        plus += 2
        mask = -1 if err > 0 else 0
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def thick_line(img: np.ndarray, a, b, thickness: int, color) -> None:
    """``cv2.line(img, a, b, color, thickness)`` for thickness > 1:
    OpenCV's ``ThickLine`` (a quad in 16.16 fixed point and a disc at each
    end). Both ends must lie in the canvas: OpenCV clips a line whose end
    lies outside first, which this does not reproduce, so it refuses one."""
    h, w = img.shape[:2]
    if not all(0 <= p[0] < w and 0 <= p[1] < h for p in (a, b)):
        raise ValueError(f"line ends {tuple(a)}, {tuple(b)} outside a "
                         f"{w} x {h} image")
    p0 = (int(a[0]) << XY_SHIFT, int(a[1]) << XY_SHIFT)
    p1 = (int(b[0]) << XY_SHIFT, int(b[1]) << XY_SHIFT)
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    t = thickness << (XY_SHIFT - 1)
    if abs(r) > 2.220446049250313e-16:
        r = (t + odd * XY_ONE * 0.5) / math.sqrt(r)
        dpx, dpy = round(dy * r), round(dx * r)
        fill_convex_poly(img, [(p0[0] + dpx, p0[1] + dpy),
                               (p0[0] - dpx, p0[1] - dpy),
                               (p1[0] - dpx, p1[1] - dpy),
                               (p1[0] + dpx, p1[1] + dpy)], color, shift=XY_SHIFT)
    radius = (t + (XY_ONE >> 1)) >> XY_SHIFT
    for p in (p0, p1):
        circle(img, ((p[0] + (XY_ONE >> 1)) >> XY_SHIFT,
                     (p[1] + (XY_ONE >> 1)) >> XY_SHIFT), radius, color)


def ellipse2poly(center, axes, angle: int, arc_start: int, arc_end: int,
                 delta: int) -> np.ndarray:
    """``cv2.ellipse2Poly``: the ellipse's outline as (N, 2) int32 points,
    stepped by ``delta`` degrees over OpenCV's degree sine table, each
    point rounded to nearest even, repeats of the last point dropped (a
    polygon of one point is the centre twice)."""
    if not 0 < delta <= 180:
        raise ValueError(f"delta {delta} outside (0, 180]")
    cx, cy = float(int(center[0])), float(int(center[1]))
    aw, ah = float(int(axes[0])), float(int(axes[1]))
    angle = int(angle)
    while angle < 0:
        angle += 360
    while angle > 360:
        angle -= 360
    if arc_start > arc_end:
        arc_start, arc_end = arc_end, arc_start
    while arc_start < 0:
        arc_start += 360
        arc_end += 360
    while arc_end > 360:
        arc_end -= 360
        arc_start -= 360
    if arc_end - arc_start > 360:
        arc_start, arc_end = 0, 360
    alpha = float(_SIN_TABLE[450 - angle])  # cos
    beta = float(_SIN_TABLE[angle])  # sin
    pts: List[Tuple[int, int]] = []
    for i in range(arc_start, arc_end + delta, delta):
        a = min(i, arc_end)
        if a < 0:
            a += 360
        x = aw * float(_SIN_TABLE[450 - a])
        y = ah * float(_SIN_TABLE[a])
        pt = (round(cx + x * alpha - y * beta), round(cy + x * beta + y * alpha))
        if not pts or pt != pts[-1]:
            pts.append(pt)
    if len(pts) == 1:
        pts = [(int(cx), int(cy))] * 2
    return np.array(pts, np.int32)
