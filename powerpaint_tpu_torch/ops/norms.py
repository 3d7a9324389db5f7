"""GroupNorm (+ SiLU), its statistics, the int8 activation quantisers and
LayerNorm: two CUDA kernels and their plain versions.

Public functions keep the JAX package's layout: the GroupNorm family takes
(B, ..., C) with channels last (an NCHW tensor in channels_last memory,
permuted to NHWC, is such a view), ``layer_norm`` normalizes the last axis.
For a CUDA tensor each launches its kernel or raises; for a CPU tensor
each runs its ``*_plain`` version, which is also the kernel's oracle.

The GroupNorm family (``group_norm``, ``group_norm_stats``,
``gn_silu_quantize_int8``, ``quantize_int8``) is one CUDA source,
``csrc/group_norm.cu``, replacing the TPU kernel
``powerpaint_tpu/ops/norms_pallas.py::_gn_kernel`` (``group_norm_fused``),
the statistics the conv kernels take, and the activation quantiser of the
int8 conv kernels. Where a map fits the shared memory of a thread-block
cluster (every UNet and BrushNet map at 512^2) it is one launch that reads
x once and writes once; the VAE's largest maps take two. How it cuts a
shape is mirrored here by ``gn_plan``; what bounds it and what its design
does about it is written at the top of the source. Statistics are the same
bits in every mode for one tensor, so ``gn_silu_quantize_int8`` quantises
exactly what its plain version (``group_norm_stats``, then PyTorch's fp32
operations) quantises.

Sequence parallelism (a canvas's rows split over the ranks of a data
group, ``parallel.sequence``): under the row context the GroupNorm family
normalises with the statistics of the whole canvas. Each rank takes the
moments (mean and M2) of its own rows (``group_norm_moments``, the
kernel's moments mode), the (2, B, G) moments are all-gathered over the
group and Chan-merged in rank order on the device (``merge_moments``), so
every rank holds the same statistics bit for bit, and the apply and the
quantiser take them as given (``stats=``) instead of computing their own.

``layer_norm`` is ``csrc/layer_norm.cu``, replacing
``norms_pallas.py::_ln_kernel`` (``layer_norm_fused``): each row in the
registers of a group of threads (lanes of one warp, or whole warps for a
wide row), at most three 16-byte vectors a thread, two-pass fp32 statistics
reduced with shuffles (and one float a warp through shared memory across
warps), gamma/beta held in registers while a block walks its rows, one read
and one write, launched as a programmatic dependent launch. How it cuts a
row is mirrored by ``ln_plan``; the cut depends on C and the element size
alone, so the kernel is batch-invariant and deterministic bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from powerpaint_tpu_torch.ops import _build
from powerpaint_tpu_torch.ops._grad import needs_grad, recompute_function
from powerpaint_tpu_torch.parallel import sequence


# ---------------------------------------------------------------------------
# plain versions (CPU path and oracle)
# ---------------------------------------------------------------------------


def group_norm_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     *, num_groups: int = 32, eps: float = 1e-6,
                     silu: bool = False, stats=None) -> torch.Tensor:
    """Two-pass fp32 GroupNorm over (B, ..., C) per (batch, group);
    ``stats``, a given (mean, rstd) pair of (B, G), replaces the statistics
    of x."""
    b, c = x.shape[0], x.shape[-1]
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    xf = x.float().reshape(b, -1, num_groups, c // num_groups)
    if stats is None:
        mean = xf.mean(dim=(1, 3), keepdim=True)
        var = (xf - mean).square().mean(dim=(1, 3), keepdim=True)
        rstd = torch.rsqrt(var + eps)
    else:
        mean, rstd = (t.reshape(b, 1, num_groups, 1) for t in stats)
    out = ((xf - mean) * rstd).reshape(x.shape)
    out = out * gamma.float() + beta.float()
    if silu:
        out = out * torch.sigmoid(out)
    return out.to(x.dtype)


def layer_norm_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     *, eps: float = 1e-5) -> torch.Tensor:
    """Two-pass fp32 LayerNorm over the last axis."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out * gamma.float() + beta.float()).to(x.dtype)


def group_norm_stats_plain(x: torch.Tensor, num_groups: int,
                           eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-pass fp32 mean and 1/sqrt(var + eps) per (batch, group), each
    (B, G)."""
    b, c = x.shape[0], x.shape[-1]
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    xf = x.float().reshape(b, -1, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3))
    var = (xf - mean[:, None, :, None]).square().mean(dim=(1, 3))
    return mean, torch.rsqrt(var + eps)


def group_norm_moments_plain(x: torch.Tensor, num_groups: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-pass fp32 mean and M2 (the sum of squared deviations from it)
    per (batch, group) of (B, ..., C), each (B, G)."""
    b, c = x.shape[0], x.shape[-1]
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    xf = x.float().reshape(b, -1, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3))
    return mean, (xf - mean[:, None, :, None]).square().sum(dim=(1, 3))


def merge_moments(means: torch.Tensor, m2s: torch.Tensor,
                  count: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chan's merge of n parts' (mean, M2), each (n, ...) of ``count``
    elements a part, in part order (the kernel's ``chan_merge``, one fp32
    operation at a time): the (mean, M2) of the whole."""
    n_a = float(count)
    mean, m2 = means[0], m2s[0]
    for r in range(1, means.shape[0]):
        n_ab = n_a + count
        frac = count / n_ab
        d = means[r] - mean
        mean = mean + d * frac
        m2 = (m2 + m2s[r]) + (d * d) * (n_a * frac)
        n_a = n_ab
    return mean, m2


def inv_scale(x_scale: float) -> float:
    """1 / x_scale rounded once to fp32: the quantiser multiplies by it, as
    the TPU kernels' inv_x_scale."""
    return float(np.float32(1.0 / float(x_scale)))


def gn_silu_fp32(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
                 num_groups: int, eps: float, stats=None) -> torch.Tensor:
    """The int8 units' activation before quantisation: GroupNorm with
    ``group_norm_stats`` statistics (or the given (mean, rstd) ``stats``),
    ``(x - mean) * (rstd * gamma) + beta``, then ``y * sigmoid(y)``, kept
    in fp32 (the bf16 path rounds it to x's dtype; the quantiser does
    not)."""
    c = x.shape[-1]
    mean, rstd = stats if stats is not None else group_norm_stats(
        x, num_groups, eps)
    rep = c // num_groups
    view = (x.shape[0],) + (1,) * (x.dim() - 2) + (c,)
    mean = mean.repeat_interleave(rep, dim=1).reshape(view)
    scale = rstd.repeat_interleave(rep, dim=1).reshape(view) * gamma.float()
    y = (x.float() - mean) * scale + beta.float()
    return y * torch.sigmoid(y)


def _quantize_plain(y: torch.Tensor, x_scale: float) -> torch.Tensor:
    return torch.clamp(torch.round(y * inv_scale(x_scale)), -127, 127).to(torch.int8)


def quantize_int8_plain(x: torch.Tensor, *, x_scale: float) -> torch.Tensor:
    """``clip(round_half_even(x * (1 / x_scale)), -127, 127)`` in fp32, int8."""
    return _quantize_plain(x.float(), x_scale)


def gn_silu_quantize_int8_plain(x: torch.Tensor, gamma: torch.Tensor,
                                beta: torch.Tensor, *, num_groups: int,
                                eps: float, x_scale: float,
                                stats=None) -> torch.Tensor:
    """``gn_silu_fp32`` then the quantiser, int8 in x's shape."""
    return _quantize_plain(gn_silu_fp32(x, gamma, beta, num_groups=num_groups,
                                        eps=eps, stats=stats), x_scale)


# ---------------------------------------------------------------------------
# GroupNorm family: csrc/group_norm.cu
# ---------------------------------------------------------------------------

_RESIDENT_BYTES = 96 * 1024
_MAX_CLUSTER = 16
_MIN_ROWS = 128
_STREAM_CHUNKS = 128
_SUB_BYTES = 32 * 1024
_STATS, _APPLY, _QUANT = 0, 1, 2


def gn_plan(s: int, c: int, groups: int, esize: int, sms: int = 132) -> dict:
    """How ``csrc/group_norm.cu`` cuts a (B, S, C) map with ``groups``
    groups of ``esize``-byte elements, as ``plan_gn`` there does it (a card
    test holds the two together), never from B. Resident form: a cluster of
    ``cluster`` blocks per (image, span of ``span`` channels, ``k`` groups),
    each block holding ``rows`` rows in shared memory; the span is the
    narrowest of whole groups whose row is a whole number of 32-byte
    sectors (16-byte vectors where no such span fits), the cluster the
    smallest power of two up to 16 whose tiles fit 96 KB, grown while a
    two-image batch leaves SMs without a block and each block keeps 128
    rows. Streamed form (no cluster
    holds the map): ``chunks`` blocks of ``rows`` rows an image, each
    staging sub-tiles of ``sub_rows`` rows. ``smem`` (and ``smem2``, the
    streamed form's second launch) in bytes."""
    gs = c // groups

    def tile(span, n):
        return -(-s // n) * span * esize

    def cluster_for(span):
        n = 1
        while n < _MAX_CLUSTER and n < s and (
                tile(span, n) > _RESIDENT_BYTES
                or (2 * (c // span) * n < sms and -(-s // (2 * n)) >= _MIN_ROWS)):
            n *= 2
        return n if tile(span, n) <= _RESIDENT_BYTES else 0

    span = n = 0
    for align in (32, 16):
        for k in range(1, groups + 1):
            if groups % k or (k * gs * esize) % align:
                continue
            n = cluster_for(k * gs)
            if n:
                span = k * gs
            break
        if span:
            break
    if not span:
        n = cluster_for(c)
        span = c if n else 0
    if span:
        rows = -(-s // n)
        k = span // gs
        return dict(resident=1, span=span, spans=c // span, k=k, cluster=n,
                    rows=rows, chunks=n, sub_rows=0,
                    smem=-(-rows * span * esize // 16) * 16
                    + 4 * (4 * span + 4 * k + max(2048, span, 2 * _MAX_CLUSTER * k)),
                    smem2=0)
    chunks = min(_STREAM_CHUNKS, s)
    rows = -(-s // chunks)
    sub_rows = max(1, min(rows, _SUB_BYTES // (c * esize)))
    return dict(resident=0, span=c, spans=1, k=groups, cluster=1, rows=rows,
                chunks=chunks, sub_rows=sub_rows,
                smem=2 * (-(-sub_rows * c * esize // 16) * 16)
                + 4 * (2 * groups + c + max(2048, c)),
                smem2=4 * (3 * c + 2 * groups))


@functools.lru_cache(maxsize=None)
def _gn_lib():
    lib = _build.load("group_norm")
    fn = lib.ppt_group_norm
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_float] * 2
                   + [ctypes.c_int] * 8 + [ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_void_p])
    ws = lib.ppt_group_norm_workspace
    ws.restype = ctypes.c_longlong
    ws.argtypes = [ctypes.c_int] * 5
    qz = lib.ppt_quantize_int8
    qz.restype = ctypes.c_int
    qz.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    return fn, ws, qz


def _check_x(x, name):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name} takes fp32 or bf16, got {x.dtype}")
    if x.dim() < 2 or not x.is_contiguous():
        raise ValueError(f"{name} needs a contiguous (B, ..., C) tensor")


def _check_affine(x, gamma, beta, name):
    c = x.shape[-1]
    for p in (gamma, beta):
        if p.shape != (c,) or p.dtype != torch.float32 or \
                p.device != x.device or not p.is_contiguous():
            raise ValueError(f"{name}: gamma/beta must be ({c},) fp32 on {x.device}")


def _launch_gn(x, gamma, beta, num_groups, eps, mode, *, silu=False,
               x_scale=None, cluster=0, stats=None, moments=False):
    """One call of ``ppt_group_norm``: returns (output or None, (2, B, G)
    statistics). ``cluster`` > 0 forces the resident form's cluster size
    (the card tests' refusal check). ``stats``: a given (mean, rstd) pair
    that the apply and quantise modes take instead of computing theirs;
    ``moments``: the statistics mode writes (mean, M2)."""
    b, c = x.shape[0], x.shape[-1]
    s = x.numel() // (b * c)
    if c % num_groups or not 0 < num_groups <= 256:
        raise ValueError(f"{tuple(x.shape)} does not split into {num_groups} "
                         "groups (1 to 256)")
    fn, ws, _ = _gn_lib()
    is_bf16 = int(x.dtype == torch.bfloat16)
    stat = torch.empty((2, b, num_groups), dtype=torch.float32, device=x.device)
    n_part = ws(b, s, c, num_groups, is_bf16)
    part = (torch.empty(n_part, dtype=torch.float32, device=x.device)
            if n_part else None)
    out = q = None
    if mode == _APPLY:
        out = torch.empty_like(x)
    elif mode == _QUANT:
        q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    given = None
    if stats is not None:
        given = torch.stack([t.to(device=x.device, dtype=torch.float32)
                             .reshape(b, num_groups) for t in stats]).contiguous()
    ptr = (lambda t: None if t is None else t.data_ptr())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), ptr(gamma), ptr(beta), ptr(out), ptr(q),
             stat.data_ptr(), ptr(part), float(eps),
             inv_scale(x_scale) if x_scale is not None else 0.0, mode,
             int(silu), is_bf16, b, s, c, num_groups, int(cluster), ptr(given),
             int(moments), stream)
    if err != 0:
        raise RuntimeError(f"group_norm kernel launch failed: CUDA error {err}")
    return (out if mode == _APPLY else q), stat


def group_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
               num_groups: int = 32, eps: float = 1e-6,
               silu: bool = False, stats=None) -> torch.Tensor:
    """GroupNorm over (B, ..., C), statistics per (batch, group) in fp32,
    then optional SiLU; output in x's dtype. gamma and beta (C,) fp32.
    ``stats``: a given (mean, rstd) pair of (B, G) fp32 to apply instead;
    under the row context (``parallel.sequence``) the whole canvas's
    (``global_group_stats``). Differentiable without either."""
    kw = dict(num_groups=num_groups, eps=eps, silu=silu)
    if stats is None and sequence.current() is not None:
        stats = global_group_stats(x, num_groups, eps)
    if stats is None and needs_grad(x, gamma, beta):
        return GroupNorm.apply(kw, x, gamma, beta)
    return _group_norm(x, gamma, beta, stats=stats, **kw)


def _group_norm(x, gamma, beta, *, num_groups, eps, silu, stats=None):
    if not x.is_cuda:
        return group_norm_plain(x, gamma, beta, num_groups=num_groups,
                                eps=eps, silu=silu, stats=stats)
    _check_x(x, "group_norm")
    _check_affine(x, gamma, beta, "group_norm")
    out, _ = _launch_gn(x, gamma, beta, num_groups, eps, _APPLY, silu=silu,
                        stats=stats)
    group_norm.launches += 1
    return out


def group_norm_stats(x: torch.Tensor, num_groups: int,
                     eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(batch, group) fp32 mean and 1/sqrt(var + eps) of (B, ..., C),
    each (B, G), for a consumer that applies the norm itself (the bf16
    conv's GroupNorm+SiLU prologue, the int8 units' plain version); under
    the row context, the whole canvas's (``global_group_stats``)."""
    if sequence.current() is not None:
        return global_group_stats(x, num_groups, eps)
    if not x.is_cuda:
        return group_norm_stats_plain(x, num_groups, eps)
    _check_x(x, "group_norm_stats")
    _, stats = _launch_gn(x, None, None, num_groups, eps, _STATS)
    group_norm_stats.launches += 1
    return stats[0], stats[1]


def group_norm_moments(x: torch.Tensor,
                       num_groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(batch, group) fp32 mean and M2 (the sum of squared deviations
    from the mean) of (B, ..., C), each (B, G): the kernel's moments mode,
    or ``group_norm_moments_plain`` for a CPU tensor."""
    if not x.is_cuda:
        return group_norm_moments_plain(x, num_groups)
    _check_x(x, "group_norm_moments")
    _, stats = _launch_gn(x, None, None, num_groups, 0.0, _STATS, moments=True)
    group_norm_moments.launches += 1
    return stats[0], stats[1]


def global_group_stats(x: torch.Tensor, num_groups: int,
                       eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Under the row context: the (mean, rstd) of the whole canvas whose
    rows this rank's x holds. This rank's moments (``group_norm_moments``)
    are all-gathered over the data group (2 B G floats a rank) and merged
    in rank order (``merge_moments``), the same operations on the same
    values on every rank, so every rank holds the same bits."""
    comm = sequence.current().comm
    mean, m2 = group_norm_moments(x, num_groups)
    parts = comm.all_gather(torch.stack([mean, m2])[None], 0)
    count = x.numel() // (x.shape[0] * num_groups)
    mean, m2 = merge_moments(parts[:, 0], parts[:, 1], count)
    return mean, 1.0 / torch.sqrt(m2 / float(count * parts.shape[0]) + eps)


def gn_silu_quantize_int8(x: torch.Tensor, gamma: torch.Tensor,
                          beta: torch.Tensor, *, num_groups: int, eps: float,
                          x_scale: float, stats=None) -> torch.Tensor:
    """The int8 units' activation: ``clip(round_half_even(silu(GN(x)) *
    (1 / x_scale)), -127, 127)`` with fp32 statistics, int8 in x's shape;
    bitwise ``gn_silu_quantize_int8_plain``. gamma and beta (C,) fp32.
    ``stats``: a given (mean, rstd) pair to quantise with; under the row
    context, the whole canvas's."""
    if stats is None and sequence.current() is not None:
        stats = global_group_stats(x, num_groups, eps)
    if not x.is_cuda:
        return gn_silu_quantize_int8_plain(x, gamma, beta, num_groups=num_groups,
                                           eps=eps, x_scale=x_scale, stats=stats)
    _check_x(x, "gn_silu_quantize_int8")
    _check_affine(x, gamma, beta, "gn_silu_quantize_int8")
    q, _ = _launch_gn(x, gamma, beta, num_groups, eps, _QUANT, x_scale=x_scale,
                      stats=stats)
    gn_silu_quantize_int8.launches += 1
    return q


def quantize_int8(x: torch.Tensor, *, x_scale: float) -> torch.Tensor:
    """``clip(round_half_even(x * (1 / x_scale)), -127, 127)``, int8 in x's
    shape; bitwise ``quantize_int8_plain``."""
    if not x.is_cuda:
        return quantize_int8_plain(x, x_scale=x_scale)
    _check_x(x, "quantize_int8")
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    err = _gn_lib()[2](x.data_ptr(), q.data_ptr(), x.numel(),
                       inv_scale(x_scale), int(x.dtype == torch.bfloat16),
                       torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"quantize_int8 kernel launch failed: CUDA error {err}")
    quantize_int8.launches += 1
    return q


# ---------------------------------------------------------------------------
# LayerNorm: csrc/layer_norm.cu
# ---------------------------------------------------------------------------

LN_MAX_C = 2048
_LN_TARGET_VECS = 3
_LN_WARP_ROWS_THREADS = 128


def ln_plan(c: int, esize: int) -> dict:
    """How ``csrc/layer_norm.cu`` cuts rows of ``c`` elements of ``esize``
    bytes, as ``plan_ln`` there does it (a card test holds the two
    together), never from the row count: a ``group`` of threads holds a
    row, at most 3 16-byte vectors each (``vecs``): a power of two up to 32
    lanes of a warp, ``rows`` rows to a block of ``threads`` = 128, where
    that holds the row; else whole warps, one row a block. (The grid, one
    wave of blocks at most, is the launch's: it takes the card's occupancy
    and cuts no row.)"""
    nv = -(-c // (16 // esize))
    group = 1
    while group < 32 and group * _LN_TARGET_VECS < nv:
        group *= 2
    if group * _LN_TARGET_VECS < nv:
        group = 32 * -(-nv // (32 * _LN_TARGET_VECS))
    threads = group if group > 32 else _LN_WARP_ROWS_THREADS
    return dict(group=group, vecs=-(-nv // group), threads=threads,
                rows=threads // group)


@functools.lru_cache(maxsize=None)
def _ln_lib():
    fn = _build.load("layer_norm").ppt_layer_norm
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_float, ctypes.c_int,
                                            ctypes.c_void_p])
    return fn


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis of a contiguous fp32 or bf16 x (C up to
    ``LN_MAX_C``), fp32 statistics, gamma and beta (C,) fp32; output in x's
    dtype."""
    if needs_grad(x, gamma, beta):
        return LayerNorm.apply({"eps": eps}, x, gamma, beta)
    return _layer_norm(x, gamma, beta, eps=eps)


def _layer_norm(x, gamma, beta, *, eps):
    if not x.is_cuda:
        return layer_norm_plain(x, gamma, beta, eps=eps)
    if x.dtype not in (torch.float32, torch.bfloat16) or not x.is_contiguous():
        raise ValueError(f"layer_norm takes a contiguous fp32 or bf16 tensor, "
                         f"got {x.dtype}")
    c = x.shape[-1]
    if not 0 < c <= LN_MAX_C:
        raise ValueError(f"layer_norm takes 1 to {LN_MAX_C} channels, got {c}")
    _check_affine(x, gamma, beta, "layer_norm")
    out = torch.empty_like(x)
    # the current stream's raw handle: no Stream object built on each of
    # the main paths' thousand calls an image
    err = _ln_lib()(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                    out.data_ptr(), x.numel() // c, c, eps,
                    int(x.dtype == torch.bfloat16),
                    torch._C._cuda_getCurrentRawStream(x.get_device()))
    if err != 0:
        raise RuntimeError(f"layer_norm kernel launch failed: CUDA error {err}")
    layer_norm.launches += 1
    return out


GroupNorm = recompute_function("GroupNorm", _group_norm, group_norm_plain)
LayerNorm = recompute_function("LayerNorm", _layer_norm, layer_norm_plain)
group_norm.launches = 0
group_norm_stats.launches = 0
group_norm_moments.launches = 0
gn_silu_quantize_int8.launches = 0
quantize_int8.launches = 0
layer_norm.launches = 0
