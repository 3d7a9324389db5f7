"""OpenCV's image functions that the control maps use, written out: Canny
edges, ``resize`` (INTER_AREA, INTER_LINEAR, INTER_CUBIC, INTER_LANCZOS4),
``GaussianBlur``, ``dilate`` with a 3 x 3 element and ``addWeighted``.

The GPU host has no OpenCV, and the JAX package's control maps call it, so
these reproduce OpenCV's own arithmetic (``imgproc/src/resize.cpp``,
``smooth.dispatch.cpp``, ``filter.simd.hpp``, ``canny.cpp``) rather than a
textbook form of each filter: the 11-bit fixed-point resize coefficients,
the rounding of its vectorised row loops, the Gaussian kernel's 8-bit
error-diffused taps, and which columns of a float filter OpenCV runs
through fused multiply-adds. ``tests/test_torch_imgproc.py`` holds each
function to ``cv2`` bit for bit on uint8 (and within 1e-6 of the largest
magnitude on float32). Where OpenCV hands a call to Intel IPP instead
(float32 INTER_LINEAR and INTER_CUBIC, uint8 INTER_CUBIC), these follow
OpenCV's own code, the one that runs without IPP; ROADMAP.md records how
far IPP's results lie from it.

``canny`` runs on the host in numpy and scipy, as the JAX package runs it.
The others take a numpy array or a torch tensor, (H, W) or (H, W, C), and
return the same kind: a tensor stays on its device, and the arithmetic is
integer, or float ops that round the same way on the card as on the CPU
(a fused multiply-add is an fp64 product and sum rounded once to fp32),
so a map made on the card is bitwise the one made on the CPU.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

INTER_LINEAR = 1
INTER_CUBIC = 2
INTER_AREA = 3
INTER_LANCZOS4 = 4

_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS
_DBL_EPSILON = 2.220446049250313e-16
_FLT_EPSILON = float(np.finfo(np.float32).eps)
_KSIZE = {INTER_LINEAR: 2, INTER_AREA: 2, INTER_CUBIC: 4, INTER_LANCZOS4: 8}
_F32 = np.float32


def _round(v: float) -> int:
    """cvRound: to nearest, ties to even."""
    return int(np.rint(v))


def writable(a: np.ndarray) -> np.ndarray:
    """A contiguous, writable array torch can wrap (a read-only one, as
    PIL gives, is copied)."""
    a = np.ascontiguousarray(a)
    return a if a.flags.writeable else a.copy()


def _hwc(img):
    """(the image as an (H, W, C) tensor, a function that gives a result
    back in the caller's kind and rank)."""
    is_np = isinstance(img, np.ndarray)
    t = torch.from_numpy(writable(img)) if is_np else img
    flat = t.dim() == 2
    if flat:
        t = t[:, :, None]
    if t.dim() != 3:
        raise ValueError(f"need an (H, W) or (H, W, C) image, got {tuple(t.shape)}")

    def back(out: torch.Tensor):
        out = out[:, :, 0] if flat else out
        return out.numpy() if is_np else out

    return t, back


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """fp32 a * b + c rounded once, as a fused multiply-add: the fp64
    product of two fp32 values is exact."""
    return (a.double() * b + c).float()


def _table(values, device, dtype) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(values), device=device, dtype=dtype)


# ------------------------------------------------------------------ canny


_TG22 = 13573  # round(tan(22.5 deg) * 2^15)


def canny(image: np.ndarray, low: float, high: float) -> np.ndarray:
    """``cv2.Canny(image, low, high)`` (aperture 3, L1 gradient) of an
    (H, W) or (H, W, C) uint8 image: (H, W) uint8, 255 on edges.

    A 3 x 3 Sobel per channel with the border replicated; the channel of
    largest |dx| + |dy| wins (the first on a tie). Non-maximum suppression
    against the two neighbours across the gradient (magnitude 0 outside
    the image) in OpenCV's 15-bit fixed point; then every 8-connected
    component of pixels that pass it with a magnitude above ``low`` and
    hold one above ``high``: the set OpenCV's hysteresis stack reaches."""
    from scipy import ndimage

    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"canny takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    lo, hi = math.floor(low), math.floor(high)
    if lo > hi:
        lo, hi = hi, lo
    p = np.pad(img.astype(np.int64), ((1, 1), (1, 1), (0, 0)), mode="edge")
    dx = ((p[:-2, 2:] + 2 * p[1:-1, 2:] + p[2:, 2:])
          - (p[:-2, :-2] + 2 * p[1:-1, :-2] + p[2:, :-2]))
    dy = ((p[2:, :-2] + 2 * p[2:, 1:-1] + p[2:, 2:])
          - (p[:-2, :-2] + 2 * p[:-2, 1:-1] + p[:-2, 2:]))
    mags = np.abs(dx) + np.abs(dy)
    c = np.argmax(mags, axis=2)[:, :, None]
    m = np.take_along_axis(mags, c, 2)[:, :, 0]
    dx = np.take_along_axis(dx, c, 2)[:, :, 0]
    dy = np.take_along_axis(dy, c, 2)[:, :, 0]
    h, w = m.shape
    mp = np.pad(m, 1)

    def at(oy, ox):
        return mp[1 + oy:1 + oy + h, 1 + ox:1 + ox + w]

    ax, ay = np.abs(dx), np.abs(dy) << 15
    tg22 = ax * _TG22
    tg67 = tg22 + (ax << 16)
    horizontal = ay < tg22
    vertical = ~horizontal & (ay > tg67)
    s = np.where((dx ^ dy) < 0, -1, 1)
    # the diagonal pair: up-right / down-left where dx and dy differ in sign
    up_diag = np.where(s < 0, at(-1, 1), at(-1, -1))
    down_diag = np.where(s < 0, at(1, -1), at(1, 1))
    keep = np.where(horizontal, (m > at(0, -1)) & (m >= at(0, 1)),
                    np.where(vertical, (m > at(-1, 0)) & (m >= at(1, 0)),
                             (m > up_diag) & (m > down_diag)))
    weak = keep & (m > lo)
    strong = weak & (m > hi)
    labels, _ = ndimage.label(weak, structure=np.ones((3, 3), bool))
    seeds = np.unique(labels[strong])
    edges = np.isin(labels, seeds[seeds > 0])
    return edges.astype(np.uint8) * 255


# ------------------------------------------------------------------ resize


def _cubic_coeffs(x: np.ndarray) -> np.ndarray:
    """OpenCV's ``interpolateCubic`` in fp32 (A = -0.75): (n, 4)."""
    a, one = _F32(-0.75), _F32(1.0)
    x = x.astype(np.float32)
    x1, mx = x + one, one - x
    c0 = ((a * x1 - _F32(5) * a) * x1 + _F32(8) * a) * x1 - _F32(4) * a
    c1 = ((a + _F32(2)) * x - (a + _F32(3))) * x * x + one
    c2 = ((a + _F32(2)) * mx - (a + _F32(3))) * mx * mx + one
    c3 = one - c0 - c1 - c2
    return np.stack([c0, c1, c2, c3], axis=1).astype(np.float32)


_S45 = 0.70710678118654752440084436210485
_LANCZOS_CS = ((1, 0), (-_S45, -_S45), (0, 1), (_S45, -_S45), (-1, 0),
               (_S45, _S45), (0, -1), (-_S45, _S45))


def _lanczos4_coeffs(xs: np.ndarray) -> np.ndarray:
    """OpenCV's ``interpolateLanczos4``: the taps in fp64 from one sine and
    cosine, each rounded to fp32, normalised in fp32: (n, 8)."""
    out = np.zeros((len(xs), 8), np.float32)
    for n, x in enumerate(xs.astype(np.float32)):
        if x < _FLT_EPSILON:
            out[n, 3] = 1.0
            continue
        x3 = float(x + _F32(3))  # x + 3 in fp32, as the C expression
        y0 = -x3 * math.pi * 0.25
        s0, c0 = math.sin(y0), math.cos(y0)
        total = _F32(0.0)
        for i, (cs, cc) in enumerate(_LANCZOS_CS):
            y = -float(x + _F32(3) - _F32(i)) * math.pi * 0.25
            out[n, i] = _F32((cs * s0 + cc * c0) / (y * y))
            total = _F32(total + out[n, i])
        out[n] *= _F32(_F32(1.0) / total)
    return out


def _taps(n_in: int, n_out: int, scale: float, inv_scale: float, mode: int,
          clamp_frac: bool) -> Tuple[np.ndarray, np.ndarray]:
    """One axis of OpenCV's generic resize: (source indices (n_out, k),
    clamped to the image, fp32 coefficients (n_out, k)). ``clamp_frac``:
    the x axis, where LINEAR and AREA set the fraction to 0 at the image's
    edges (the y axis only clamps the rows it reads)."""
    k = _KSIZE[mode]
    d = np.arange(n_out)
    if mode == INTER_AREA:  # INTER_AREA upsampling: OpenCV's linear emulation
        s = np.floor(d * scale).astype(np.int64)
        f = ((d + 1) - (s + 1) * inv_scale).astype(np.float32)
        f = np.where(f <= 0, _F32(0), f - np.floor(f).astype(np.float32))
    else:
        f = ((d + 0.5) * scale - 0.5).astype(np.float32)
        s = np.floor(f).astype(np.int64)
        f = f - s.astype(np.float32)
    f = f.astype(np.float32)
    if clamp_frac and k == 2:
        low = s < 0
        f, s = np.where(low, _F32(0), f), np.where(low, 0, s)
        high = s + 1 >= n_in
        f, s = np.where(high, _F32(0), f), np.where(high, n_in - 1, s)
    if mode == INTER_CUBIC:
        coeffs = _cubic_coeffs(f)
    elif mode == INTER_LANCZOS4:
        coeffs = _lanczos4_coeffs(f)
    else:
        coeffs = np.stack([_F32(1) - f, f], axis=1).astype(np.float32)
    idx = np.clip(s[:, None] + np.arange(1 - k // 2, k // 2 + 1)[None], 0, n_in - 1)
    return idx, coeffs


def _fixed(coeffs: np.ndarray) -> np.ndarray:
    """saturate_cast<short>(c * 2048): round to nearest, ties to even."""
    return np.rint(coeffs * _F32(_COEF_SCALE)).astype(np.int64)


def _resize_generic_u8(x, dw, xi, xc, yi, yc, mode):
    """uint8 through OpenCV's fixed point: exact int32 row sums with 11-bit
    coefficients, then the column pass as OpenCV's row loops round it."""
    dev, c = x.device, x.shape[2]
    ix, iy = _table(xi, dev, torch.long), _table(yi, dev, torch.long)
    ax, ay = _fixed(xc), _fixed(yc)
    src = x.to(torch.int32)
    rows = None
    for j in range(ix.shape[1]):
        t = src[:, ix[:, j]] * _table(ax[:, j, None], dev, torch.int32)
        rows = t if rows is None else rows + t
    taps = [rows[iy[:, j]] for j in range(iy.shape[1])]  # (dh, dw, C) each
    beta = [_table(ay[:, j, None, None], dev, torch.int32) for j in range(ay.shape[1])]
    if mode in (INTER_LINEAR, INTER_AREA):
        # VResizeLinearVec_32s8u: ((S >> 4) * b) >> 16 per tap, then (t + 2) >> 2
        t = (((taps[0] >> 4) * beta[0]) >> 16) + (((taps[1] >> 4) * beta[1]) >> 16)
        return ((t + 2) >> 2).clamp(0, 255).to(torch.uint8)
    exact = sum(tp.long() * b for tp, b in zip(taps, beta))
    fixed = ((exact + (1 << (2 * _COEF_BITS - 1))) >> (2 * _COEF_BITS)).clamp(0, 255)
    if mode == INTER_LANCZOS4:
        return fixed.to(torch.uint8)
    # INTER_CUBIC: VResizeCubicVec_32s8u on whole groups of 8 row elements
    # (fp32: b0*S0 + (b1*S1 + (b2*S2 + b3*S3)), rounded to nearest even),
    # OpenCV's scalar fixed point on the rest of the row
    scale = _F32(1.0 / (_COEF_SCALE * _COEF_SCALE))
    bf = [_table((ay[:, j] * scale).astype(np.float32)[:, None, None], dev,
                 torch.float32) for j in range(4)]
    acc = taps[3].float() * bf[3]
    for j in (2, 1, 0):
        acc = taps[j].float() * bf[j] + acc
    vec = torch.round(acc).clamp(0, 255)
    body = (dw * c) // 8 * 8
    cols = torch.arange(dw * c, device=dev).view(dw, c) < body
    return torch.where(cols, vec, fixed).to(torch.uint8)


def _resize_generic_f32(x, xi, xc, yi, yc, mode):
    """fp32 (OpenCV's float resize, without IPP): row taps summed in order,
    then the column taps (cubic: nested as its vector loop)."""
    dev = x.device
    ix, iy = _table(xi, dev, torch.long), _table(yi, dev, torch.long)
    rows = None
    for j in range(ix.shape[1]):
        t = x[:, ix[:, j]] * _table(xc[:, j, None], dev, torch.float32)
        rows = t if rows is None else rows + t
    taps = [rows[iy[:, j]] * _table(yc[:, j, None, None], dev, torch.float32)
            for j in range(iy.shape[1])]
    if mode == INTER_CUBIC:
        return taps[0] + (taps[1] + (taps[2] + taps[3]))
    out = taps[0]
    for t in taps[1:]:
        out = out + t
    return out


def _area_table(n_in: int, n_out: int, scale: float):
    """OpenCV's ``computeResizeAreaTab``: each output's source indices and
    fp32 weights, (n_out, taps), padded with weight 0."""
    rows = []
    for d in range(n_out):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_in - f1)
        s1, s2 = math.ceil(f1), math.floor(f2)
        s2 = min(s2, n_in - 1)
        s1 = min(s1, s2)
        row = []
        if s1 - f1 > 1e-3:
            row.append((s1 - 1, (s1 - f1) / cell))
        row += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            row.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
        rows.append(row)
    taps = max(len(r) for r in rows)
    idx = np.zeros((n_out, taps), np.int64)
    wts = np.zeros((n_out, taps), np.float32)
    for d, row in enumerate(rows):
        for t, (s, a) in enumerate(row):
            idx[d, t], wts[d, t] = s, a
    return idx, wts


def _resize_area(x, dh, dw, scale_x, scale_y):
    """INTER_AREA downscaling by a non-integer factor (ResizeArea_Invoker):
    fp32 sums of the covered source pixels in order, rows then columns."""
    sh, sw = x.shape[:2]
    dev = x.device
    xi, xw = _area_table(sw, dw, scale_x)
    yi, yw = _area_table(sh, dh, scale_y)
    ix, iy = _table(xi, dev, torch.long), _table(yi, dev, torch.long)
    src = x.float()
    rows = torch.zeros((sh, dw, x.shape[2]), dtype=torch.float32, device=dev)
    for t in range(ix.shape[1]):
        rows = rows + src[:, ix[:, t]] * _table(xw[:, t, None], dev, torch.float32)
    out = torch.zeros((dh, dw, x.shape[2]), dtype=torch.float32, device=dev)
    for t in range(iy.shape[1]):
        out = out + _table(yw[:, t, None, None], dev, torch.float32) * rows[iy[:, t]]
    if x.dtype == torch.uint8:
        return torch.round(out).clamp(0, 255).to(torch.uint8)
    return out


def _resize_area_fast(x, dh, dw, kx, ky):
    """INTER_AREA by integer factors (ResizeAreaFast_Invoker): uint8 2 x 2
    blocks as (sum + 2) >> 2, other whole blocks as sum * (1 / area) in fp32,
    blocks cut by the image's edge as sum / count, each rounded to nearest
    even."""
    sh, sw, c = x.shape
    dev = x.device
    u8 = x.dtype == torch.uint8
    acc_t = torch.int32 if u8 else torch.float32
    # (channels, then columns, then rows): blocks past the edge padded
    pad = (0, 0, 0, max(dw * kx - sw, 0), 0, max(dh * ky - sh, 0))
    src = torch.nn.functional.pad(x.to(acc_t), pad)[:dh * ky, :dw * kx]
    valid = torch.nn.functional.pad(
        torch.ones((sh, sw, 1), dtype=acc_t, device=dev), pad)[:dh * ky, :dw * kx]
    src = src.reshape(dh, ky, dw, kx, c)
    count = valid.reshape(dh, ky, dw, kx, 1).sum(dim=(1, 3))
    total = None
    for a in range(ky):  # OpenCV's order: block rows, then columns
        for b in range(kx):
            t = src[:, a, :, b]
            total = t if total is None else total + t
    area = kx * ky
    whole = count == area
    if u8:
        if kx == 2 and ky == 2 and c in (1, 3, 4):
            full = (total + 2) >> 2
        else:
            full = torch.round(total.float() * _F32(1.0 / area))
        part = torch.round(total.float() / count.clamp(min=1).float())
        return torch.where(whole, full.to(torch.int32), part.to(torch.int32)
                           ).clamp(0, 255).to(torch.uint8)
    return torch.where(whole, total * _F32(1.0 / area), total / count.clamp(min=1))


def resize(img, dsize: Optional[Sequence[int]] = None, fx: Optional[float] = None,
           fy: Optional[float] = None, interpolation: int = INTER_LINEAR):
    """``cv2.resize``: ``dsize`` is (width, height); without it the size is
    the input's times ``fx`` / ``fy`` rounded as OpenCV rounds it, and the
    source step is 1 / fx (not in / out). uint8 (1 or 3 channels) or fp32
    (any channel count), with OpenCV's half-pixel geometry and its special
    cases: the same size is a copy, INTER_LINEAR by exactly 2 on both axes
    is INTER_AREA, INTER_AREA by integer factors sums blocks, INTER_AREA
    upwards is its linear emulation."""
    x, back = _hwc(img)
    if x.dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"resize takes uint8 or float32, got {x.dtype}")
    if interpolation not in _KSIZE:
        raise ValueError(f"unknown interpolation {interpolation}")
    sh, sw = x.shape[:2]
    if dsize is None or tuple(dsize) == (0, 0):
        if not (fx and fy and fx > 0 and fy > 0):
            raise ValueError("resize needs dsize or positive fx and fy")
        inv_x, inv_y = float(fx), float(fy)
        dw, dh = _round(sw * inv_x), _round(sh * inv_y)
    else:
        dw, dh = int(dsize[0]), int(dsize[1])
        inv_x, inv_y = dw / sw, dh / sh
    if dw <= 0 or dh <= 0:
        raise ValueError(f"resize to {dw} x {dh}")
    if (dh, dw) == (sh, sw):
        return back(x.clone())
    scale_x, scale_y = 1.0 / inv_x, 1.0 / inv_y
    kx, ky = _round(scale_x), _round(scale_y)
    area_fast = abs(scale_x - kx) < _DBL_EPSILON and abs(scale_y - ky) < _DBL_EPSILON
    mode = interpolation
    if mode == INTER_LINEAR and area_fast and kx == 2 and ky == 2:
        mode = INTER_AREA
    if mode == INTER_AREA and scale_x >= 1 and scale_y >= 1:
        if area_fast:
            return back(_resize_area_fast(x, dh, dw, kx, ky))
        return back(_resize_area(x, dh, dw, scale_x, scale_y))
    xi, xc = _taps(sw, dw, scale_x, inv_x, mode, clamp_frac=True)
    yi, yc = _taps(sh, dh, scale_y, inv_y, mode, clamp_frac=False)
    if x.dtype == torch.uint8:
        return back(_resize_generic_u8(x, dw, xi, xc, yi, yc, mode))
    return back(_resize_generic_f32(x, xi, xc, yi, yc, mode))


# ------------------------------------------------------------------ blur


def _gaussian_kernel(n: int, sigma: float) -> list:
    """OpenCV's ``getGaussianKernelBitExact`` (fp64): n odd taps summing to
    1, the centre 1 / sum."""
    scale2 = -0.125 / (sigma * sigma)
    half = (n - 1) // 2
    vals = [math.exp((x * x) * scale2) for x in range(1 - n, 1 - n + 2 * half, 2)]
    inv = 1.0 / (sum(vals) * 2.0 + 1.0)  # summed in order, as OpenCV does
    side = [v * inv for v in vals]
    return side + [inv] + side[::-1]


def _fixed_kernel(k: list, bits: int = 8) -> list:
    """``getGaussianKernelFixedPoint_ED``: the side taps rounded with the
    error carried from tap to tap, the centre taking what keeps the sum at
    exactly 2^bits."""
    n, one = len(k), 1 << bits
    out = [0] * n
    err, total = 0.0, 0
    for i in range(n // 2):
        adj = k[i] * one + err
        v = _round(adj)
        err = adj - v
        out[i] = out[n - 1 - i] = v
        total += v
    out[n // 2] = one - 2 * total
    return out


def _reflect101(n: int, r: int) -> np.ndarray:
    """(n, 2r + 1) source indices of each position's window under
    BORDER_REFLECT_101 (reflected again where the window is wider than the
    image)."""
    p = np.arange(n)[:, None] + np.arange(-r, r + 1)[None]
    if n == 1:
        return np.zeros_like(p)
    period = 2 * n - 2
    p = np.mod(p, period)
    return np.where(p >= n, period - p, p)


def gaussian_blur(img, sigma: float):
    """``cv2.GaussianBlur(img, (0, 0), sigma)`` with BORDER_REFLECT_101.

    uint8: OpenCV's bit-exact fixed point (8-bit taps from
    ``_fixed_kernel``, 16.16 column sums, rounded). fp32: the fp32 taps of
    the same fp64 kernel, a row filter of fused multiply-adds in tap order
    (on the last ``width % 4`` elements of a row, plain multiply-adds over
    the taps in whole groups of 4 and fused ones on the rest), then a
    symmetric column filter, fused on whole groups of 8 row elements and
    plain on the rest, as OpenCV's AVX2 loops and their compiled tails
    run: bitwise for kernels of 7 taps and more (sigma from 0.6); OpenCV
    runs smaller ones through other filters, which these match within
    2e-7 of the largest magnitude."""
    x, back = _hwc(img)
    u8 = x.dtype == torch.uint8
    if not u8 and x.dtype != torch.float32:
        raise ValueError(f"gaussian_blur takes uint8 or float32, got {x.dtype}")
    h, w, c = x.shape
    n = _round(sigma * (3 if u8 else 4) * 2 + 1) | 1
    k = _gaussian_kernel(n, sigma)
    r = n // 2
    dev = x.device
    run_rows, run_cols = w > 1 and n > 1, h > 1 and n > 1
    xi = _table(_reflect101(w, r), dev, torch.long) if run_rows else None
    yi = _table(_reflect101(h, r), dev, torch.long) if run_cols else None
    if u8:
        kq = _fixed_kernel(k)
        rows = x.to(torch.int32)
        if run_rows:
            src, rows = rows, None
            for j, q in enumerate(kq):
                t = src[:, xi[:, j]] * q
                rows = t if rows is None else rows + t
        else:
            rows = rows << 8
        if run_cols:
            out = None
            for j, q in enumerate(kq):
                t = rows[yi[:, j]] * q
                out = t if out is None else out + t
        else:
            out = rows << 8
        return back(((out + (1 << 15)) >> 16).clamp(0, 255).to(torch.uint8))
    kf = [float(_F32(v)) for v in k]
    out = x
    if run_rows:
        fused = plain = None
        unrolled = 1 + (n - 1) // 4 * 4  # the tail's taps in whole groups of 4
        for j, q in enumerate(kf):
            s = x[:, xi[:, j]]
            fused = (s * q) if fused is None else _fma(s, q, fused)
            if plain is None:
                plain = s * q
            elif j < unrolled:
                plain = plain + s * q
            else:
                plain = _fma(s, q, plain)
        flat = torch.arange(w * c, device=dev).view(w, c)
        out = torch.where(flat < (w * c) // 4 * 4, fused, plain)
    if run_cols:
        rows = out
        centre = rows[yi[:, r]]
        fused, plain = centre * kf[r], centre * kf[r]
        for j in range(1, r + 1):
            pair = rows[yi[:, r + j]] + rows[yi[:, r - j]]
            fused = _fma(pair, kf[r + j], fused)
            plain = plain + pair * kf[r + j]
        flat = torch.arange(w * c, device=dev).view(w, c)
        out = torch.where(flat < (w * c) // 8 * 8, fused, plain)
    return back(out.clone() if out is x else out)


def dilate(img, kernel):
    """``cv2.dilate(img, kernel)`` for a 3 x 3 0/1 element, anchored at its
    centre: the largest value under the element's ones. Outside the image
    it reads the type's lowest value (-FLT_MAX for fp32), as OpenCV does, so
    the border never wins where the element covers a pixel of the image."""
    x, back = _hwc(img)
    k = np.asarray(kernel)
    if k.shape != (3, 3):
        raise ValueError(f"dilate takes a 3 x 3 element, got {k.shape}")
    h, w = x.shape[:2]
    low = 0 if x.dtype == torch.uint8 else float(np.finfo(np.float32).min)
    pad = torch.full((h + 2, w + 2, x.shape[2]), low, dtype=x.dtype, device=x.device)
    pad[1:-1, 1:-1] = x
    out = None
    for dy, dx in zip(*np.nonzero(k)):
        t = pad[dy:dy + h, dx:dx + w]
        out = t if out is None else torch.maximum(out, t)
    return back(out.clone())


def add_weighted(a, alpha: float, b, beta: float, gamma: float):
    """``cv2.addWeighted(a, alpha, b, beta, gamma)`` for uint8: fp32
    a * alpha + (b * beta + gamma), each step fused as OpenCV's vector loop
    runs it, rounded to nearest even and saturated."""
    ta, back = _hwc(a)
    tb, _ = _hwc(b)
    if ta.dtype != torch.uint8 or tb.dtype != torch.uint8 or ta.shape != tb.shape:
        raise ValueError("add_weighted takes two uint8 images of one shape")
    al, be, ga = (float(_F32(v)) for v in (alpha, beta, gamma))
    t = _fma(tb.float(), be, ga)
    t = _fma(ta.float(), al, t)
    return back(torch.round(t).clamp(0, 255).to(torch.uint8))
