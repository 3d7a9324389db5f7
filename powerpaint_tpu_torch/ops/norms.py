"""GroupNorm (+ SiLU) and LayerNorm: Triton kernels and their plain versions.

Public functions keep the JAX package's layout: ``group_norm`` takes
(B, ..., C) with channels last (an NCHW tensor in channels_last memory,
permuted to NHWC, is such a view), ``layer_norm`` normalizes the last axis.
For a CUDA tensor each launches its Triton kernel or raises; for a CPU
tensor each runs its ``*_plain`` version, which is also the kernels'
oracle.

Kernel 2, ``group_norm``, replaces the TPU kernel
``powerpaint_tpu/ops/norms_pallas.py::_gn_kernel`` (``group_norm_fused``).
It is bound by memory: a read and a write of x is the least it could move.
The TPU kernel held one whole feature map in VMEM and took single-pass
E[x^2] - mean^2 statistics; neither carries over. Here three launches:
(1) per-(batch, chunk of rows) partial statistics of every group, each
tile read in full rows of C (coalesced) as a [rows, groups, group width]
block, mean and M2 taken two-pass inside the tile, so a 262144 x 128 VAE
map spreads over thousands of programs; (2) per (batch, group), Chan's
merge of the partials into mean and 1/std, exact to fp32 rounding at any
size; (3) normalize, gamma/beta, optional SiLU, one more read and the
write. That is two reads and one write: 1.5x the bound.

Kernel 3, ``layer_norm``, replaces ``norms_pallas.py::_ln_kernel``
(``layer_norm_fused``): one program per row, the row held in registers
(BLOCK = next power of two >= C, C <= 1280 on the main path), two-pass fp32
statistics, gamma/beta. One read and one write, the bound itself.

Triton exists only on the GPU host: it is imported, and the kernels are
compiled, at the first launch. Until then ``tl`` below is None; the kernel
bodies resolve it at compile time.
"""

from __future__ import annotations

import functools
import types

import torch

tl = None  # triton.language, bound by _kernels() at the first launch


# ---------------------------------------------------------------------------
# plain versions (CPU path and oracle)
# ---------------------------------------------------------------------------


def group_norm_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     *, num_groups: int = 32, eps: float = 1e-6,
                     silu: bool = False) -> torch.Tensor:
    """Two-pass fp32 GroupNorm over (B, ..., C) per (batch, group)."""
    b, c = x.shape[0], x.shape[-1]
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    xf = x.float().reshape(b, -1, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 3), keepdim=True)
    out = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
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


# ---------------------------------------------------------------------------
# Triton kernels (compiled at the first launch)
# ---------------------------------------------------------------------------


def _gn_partial_kernel(X, PMEAN, PM2, S, C, GS, NG, n_chunks,
                       BLOCK_S: "tl.constexpr", G: "tl.constexpr",
                       GSP: "tl.constexpr"):
    """Partial mean and M2 of every group over one chunk of rows."""
    b = tl.program_id(0)
    chunk = tl.program_id(1)
    rows = chunk * BLOCK_S + tl.arange(0, BLOCK_S)
    g = tl.arange(0, G)
    j = tl.arange(0, GSP)
    col = g[None, :, None] * GS + j[None, None, :]
    mask = ((rows[:, None, None] < S) & (g[None, :, None] < NG)
            & (j[None, None, :] < GS))
    offs = (b.to(tl.int64) * S * C + rows[:, None, None].to(tl.int64) * C
            + col)
    x = tl.load(X + offs, mask=mask, other=0.0).to(tl.float32)
    n_rows = tl.minimum(S - chunk * BLOCK_S, BLOCK_S)
    cnt = (n_rows * GS).to(tl.float32)
    mean = tl.sum(tl.sum(x, axis=2), axis=0) / cnt
    dx = tl.where(mask, x - mean[None, :, None], 0.0)
    m2 = tl.sum(tl.sum(dx * dx, axis=2), axis=0)
    out = (b * n_chunks + chunk) * G + g
    tl.store(PMEAN + out, mean)
    tl.store(PM2 + out, m2)


def _gn_finalize_kernel(PMEAN, PM2, MEAN, RSTD, S, GS, NG, n_chunks, eps,
                        BLOCK_S: "tl.constexpr", G: "tl.constexpr",
                        BLOCK_N: "tl.constexpr"):
    """Chan's merge of the partials of one (batch, group)."""
    pid = tl.program_id(0)
    b = pid // NG
    g = pid % NG
    total = S * GS * 1.0  # float even where Triton made S or GS a constant
    acc = tl.zeros([BLOCK_N], dtype=tl.float32)
    for start in range(0, n_chunks, BLOCK_N):
        i = start + tl.arange(0, BLOCK_N)
        m = i < n_chunks
        mu = tl.load(PMEAN + (b * n_chunks + i) * G + g, mask=m, other=0.0)
        n_i = (tl.minimum(S - i * BLOCK_S, BLOCK_S) * GS).to(tl.float32)
        acc += tl.where(m, n_i * mu, 0.0)
    mean = tl.sum(acc, axis=0) / total
    acc = tl.zeros([BLOCK_N], dtype=tl.float32)
    for start in range(0, n_chunks, BLOCK_N):
        i = start + tl.arange(0, BLOCK_N)
        m = i < n_chunks
        mu = tl.load(PMEAN + (b * n_chunks + i) * G + g, mask=m, other=0.0)
        m2 = tl.load(PM2 + (b * n_chunks + i) * G + g, mask=m, other=0.0)
        n_i = (tl.minimum(S - i * BLOCK_S, BLOCK_S) * GS).to(tl.float32)
        d = mu - mean
        acc += tl.where(m, m2 + n_i * d * d, 0.0)
    var = tl.sum(acc, axis=0) / total
    tl.store(MEAN + pid, mean)
    tl.store(RSTD + pid, 1.0 / tl.sqrt(var + eps))


def _gn_apply_kernel(X, Y, W, B, MEAN, RSTD, S, C, GS, NG,
                     BLOCK_R: "tl.constexpr", CP: "tl.constexpr",
                     SILU: "tl.constexpr"):
    """(x - mean) * rstd * gamma + beta, then SiLU when asked."""
    b = tl.program_id(0)
    rows = tl.program_id(1) * BLOCK_R + tl.arange(0, BLOCK_R)
    cols = tl.arange(0, CP)
    cm = cols < C
    grp = cols // GS
    mean = tl.load(MEAN + b * NG + grp, mask=cm, other=0.0)
    rstd = tl.load(RSTD + b * NG + grp, mask=cm, other=0.0)
    w = tl.load(W + cols, mask=cm, other=0.0).to(tl.float32)
    bias = tl.load(B + cols, mask=cm, other=0.0).to(tl.float32)
    mask = (rows[:, None] < S) & cm[None, :]
    offs = b.to(tl.int64) * S * C + rows[:, None].to(tl.int64) * C + cols[None, :]
    x = tl.load(X + offs, mask=mask, other=0.0).to(tl.float32)
    y = (x - mean[None, :]) * rstd[None, :] * w[None, :] + bias[None, :]
    if SILU:
        y = y / (1.0 + tl.exp(-y))
    tl.store(Y + offs, y.to(Y.dtype.element_ty), mask=mask)


def _ln_kernel(X, Y, W, B, C, eps, BLOCK: "tl.constexpr"):
    """One row: two-pass fp32 statistics, gamma/beta."""
    row = tl.program_id(0).to(tl.int64)
    cols = tl.arange(0, BLOCK)
    m = cols < C
    x = tl.load(X + row * C + cols, mask=m, other=0.0).to(tl.float32)
    mean = tl.sum(x, axis=0) / C
    d = tl.where(m, x - mean, 0.0)
    var = tl.sum(d * d, axis=0) / C
    rstd = 1.0 / tl.sqrt(var + eps)
    w = tl.load(W + cols, mask=m, other=0.0).to(tl.float32)
    bias = tl.load(B + cols, mask=m, other=0.0).to(tl.float32)
    y = d * rstd * w + bias
    tl.store(Y + row * C + cols, y.to(Y.dtype.element_ty), mask=m)


@functools.lru_cache(maxsize=None)
def _kernels():
    global tl
    import triton
    import triton.language as language

    tl = language
    return types.SimpleNamespace(
        gn_partial=triton.jit(_gn_partial_kernel),
        gn_finalize=triton.jit(_gn_finalize_kernel),
        gn_apply=triton.jit(_gn_apply_kernel),
        ln=triton.jit(_ln_kernel),
    )


def _pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


_TILE = 4096  # elements per program in the GroupNorm tiles


def _check(x, gamma, beta, name):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name} takes fp32 or bf16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} needs a contiguous (B, ..., C) tensor")
    c = x.shape[-1]
    for p in (gamma, beta):
        if p.shape != (c,) or p.device != x.device or not p.is_contiguous():
            raise ValueError(f"{name}: gamma/beta must be ({c},) on {x.device}")


def _launch_group_norm(x, gamma, beta, num_groups, eps, silu):
    k = _kernels()
    b, c = x.shape[0], x.shape[-1]
    s = x.numel() // (b * c)
    gs = c // num_groups
    gp, gsp = _pow2(num_groups), _pow2(gs)
    block_s = max(1, _TILE // (gp * gsp))
    n_chunks = -(-s // block_s)
    part = torch.empty((2, b, n_chunks, gp), dtype=torch.float32,
                       device=x.device)
    stats = torch.empty((2, b, num_groups), dtype=torch.float32,
                        device=x.device)
    k.gn_partial[(b, n_chunks)](
        x, part[0], part[1], s, c, gs, num_groups, n_chunks,
        BLOCK_S=block_s, G=gp, GSP=gsp, num_warps=4)
    k.gn_finalize[(b * num_groups,)](
        part[0], part[1], stats[0], stats[1], s, gs, num_groups, n_chunks,
        float(eps), BLOCK_S=block_s, G=gp, BLOCK_N=1024, num_warps=4)
    out = torch.empty_like(x)
    cp = _pow2(c)
    block_r = max(1, _TILE // cp)
    k.gn_apply[(b, -(-s // block_r))](
        x, out, gamma, beta, stats[0], stats[1], s, c, gs, num_groups,
        BLOCK_R=block_r, CP=cp, SILU=bool(silu), num_warps=4)
    return out


def group_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
               num_groups: int = 32, eps: float = 1e-6,
               silu: bool = False) -> torch.Tensor:
    """GroupNorm over (B, ..., C), statistics per (batch, group) in fp32,
    then optional SiLU; output in x's dtype."""
    if not x.is_cuda:
        return group_norm_plain(x, gamma, beta, num_groups=num_groups,
                                eps=eps, silu=silu)
    _check(x, gamma, beta, "group_norm")
    if x.dim() < 2 or x.shape[-1] % num_groups:
        raise ValueError(f"group_norm: {tuple(x.shape)} with {num_groups} groups")
    out = _launch_group_norm(x, gamma, beta, num_groups, eps, silu)
    group_norm.launches += 1
    return out


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, fp32 statistics; output in x's dtype."""
    if not x.is_cuda:
        return layer_norm_plain(x, gamma, beta, eps=eps)
    _check(x, gamma, beta, "layer_norm")
    c = x.shape[-1]
    out = torch.empty_like(x)
    _kernels().ln[(x.numel() // c,)](
        x, out, gamma, beta, c, float(eps), BLOCK=_pow2(c),
        num_warps=4 if c <= 1024 else 8)
    layer_norm.launches += 1
    return out


group_norm.launches = 0
layer_norm.launches = 0
