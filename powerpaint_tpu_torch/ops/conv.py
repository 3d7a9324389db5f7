"""3x3 stride-1 SAME convolution on NHWC tensors, with or without a
GroupNorm + SiLU prologue.

``conv3x3_gn_silu`` computes ``conv3x3(silu(group_norm(x))) + bias`` and
``conv3x3`` computes ``conv3x3(x) + bias``: the functions of the TPU kernels
``powerpaint_tpu/ops/conv_pallas.py::_fused_kernel`` and ``_plain_kernel``.
Both wrap one hand-written CUDA kernel, ``csrc/conv3x3.cu`` (an implicit
GEMM on the tensor cores, the prologue a compile-time flag); the GroupNorm
statistics come first from ``ops.norms.group_norm_stats`` (one launch of
``csrc/group_norm.cu`` at the UNet's maps), so a ResNet unit costs two
launches, and the normalised activation never goes through device memory.
What bounds the kernel and what its design does about it is written at the
top of the ``.cu`` source.

Activations are (B, H, W, C) and the weight is PyTorch's (Cout, Cin, 3, 3);
the kernel reads it as (Cout, 3, 3, Cin), which is that weight in
channels-last memory, the format ``io.weights.load_models`` stores every
conv weight in. For a CUDA tensor each wrapper launches the kernel or
raises; for a CPU tensor it runs its ``*_plain`` version (GroupNorm then
``F.conv2d``), which is also the kernel's oracle.

Both are differentiable: where an input requires a gradient the call goes
through ``Conv3x3`` / ``Conv3x3GnSilu``, whose backward recomputes the
plain version (``ops._grad``); the launch counters count forward launches.

The static-scale int8 forms of both (``conv3x3_gn_silu_int8``,
``conv3x3_int8``, the JAX package's ``POWERPAINT_INT8`` path) quantise the
activation with ``ops.norms`` and run a second kernel,
``csrc/conv3x3_int8.cu``; they are described below.

Under the row context of sequence parallelism (``parallel.sequence``) all
four run on this rank's rows of a canvas: the GroupNorm statistics are the
whole canvas's, taken from this rank's own rows (``ops.norms``), x gains
one row of each neighbouring rank (``sequence.with_halo``, a torch copy),
the unchanged kernel runs on it (its prologue normalises the halo rows
with the same statistics; it pads zeros only at the canvas's edge, where
no neighbour is), and the output rows of the halo are dropped. The plans
take the odd heights (h + 1, h + 2) as they are: ``bf16_plan`` and
``int8_plan`` count 8 x 8 tiles with ragged edges, and the kernels mask
the rows past H.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from powerpaint_tpu_torch.ops import _build
from powerpaint_tpu_torch.ops._grad import needs_grad, recompute_function
from powerpaint_tpu_torch.ops.norms import (
    gn_silu_quantize_int8,
    gn_silu_quantize_int8_plain,
    group_norm_plain,
    group_norm_stats,
    quantize_int8,
    quantize_int8_plain,
)
from powerpaint_tpu_torch.parallel import sequence


def conv3x3_plain(x: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``F.conv2d`` with padding 1 on the NCHW view of NHWC ``x``."""
    return F.conv2d(x.permute(0, 3, 1, 2), weight, bias,
                    padding=1).permute(0, 2, 3, 1)


def conv3x3_gn_silu_plain(x: torch.Tensor, weight: torch.Tensor,
                          bias: Optional[torch.Tensor], gamma: torch.Tensor,
                          beta: torch.Tensor, *, num_groups: int,
                          eps: float, stats=None) -> torch.Tensor:
    """GroupNorm + SiLU in fp32 (with the given (mean, rstd) ``stats``
    where given), rounded to x's dtype, then the conv."""
    h = group_norm_plain(x, gamma, beta, num_groups=num_groups, eps=eps,
                         silu=True, stats=stats)
    return conv3x3_plain(h, weight, bias)


def bf16_plan(b: int, h: int, w: int, cin: int, cout: int,
              sms: int = 132) -> dict:
    """How the bf16 kernel cuts a shape, as ``plan_bf16`` in
    ``csrc/conv3x3.cu`` does it (a card test holds the two together): 8 x 8
    pixel tiles of one image, two a block; the Cout tile ``bn`` of (256,
    160, 128, 64) and the K split into ``splits`` runs of ``per``
    64-channel chunks that an estimate of the clocks of a two-image batch
    finds fastest, among the tiles that pad Cout least (never from ``b``,
    so an image's sums run in the same order in any batch; ties keep the
    wider tile and fewer splits); shared memory in bytes."""
    tiles_img = -(-h // 8) * -(-w // 8)
    n_chunks = -(-cin // 64)
    options = (256, 160, 128, 64)
    least = min(-(-cout // n) * n for n in options)
    best = None
    for bn in options:
        n_tiles = -(-cout // bn)
        if n_tiles * bn > least:
            continue
        t_mma = max(bn / 2.0, 16.0 + bn / 4.0)
        for want in range(1, n_chunks + 1):
            per = -(-n_chunks // want)
            splits = -(-n_chunks // per)
            if splits != want:
                continue
            waves = float(-(-(tiles_img * n_tiles * splits) // sms))
            cost = waves * (per * 72.0 * t_mma + 6000.0 +
                            (12.0 * splits * bn if splits > 1 else 0.0))
            if best is None or cost < best[0]:
                best = (cost, bn, n_tiles, per, splits)
    _, bn, n_tiles, per, splits = best
    stages = min(8, 160 * 1024 // (bn * 128))
    smem = 1024 + 2 * 2 * 13 * 1024 + stages * bn * 128 + 8 * (6 + 2 * stages)
    return dict(bn=bn, tiles=b * tiles_img, blocks=-(-(b * tiles_img) // 2),
                n_tiles=n_tiles, splits=splits, per=per, smem=smem)


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load("conv3x3")
    fn = lib.ppt_conv3x3
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    ws = lib.ppt_conv3x3_workspace
    ws.restype = ctypes.c_longlong
    ws.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
    return fn, ws


def _check(name, x, weight, bias):
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{name} takes a contiguous (B, H, W, C) tensor")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name} takes fp32 or bf16, got {x.dtype}")
    cout = weight.shape[0]
    if weight.shape != (cout, x.shape[-1], 3, 3):
        raise ValueError(f"{name}: weight {tuple(weight.shape)} is not "
                         f"(Cout, {x.shape[-1]}, 3, 3)")
    if not weight.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name} needs the weight in channels-last memory "
                         "(Conv2D.kernel_weight gives it)")
    for t in (weight, bias):
        if t is not None and (t.dtype != x.dtype or t.device != x.device):
            raise ValueError(f"{name}: weight and bias must be {x.dtype} on "
                             f"{x.device}")
    if bias is not None and (bias.shape != (cout,) or not bias.is_contiguous()):
        raise ValueError(f"{name}: bias must be ({cout},)")


def _launch(x, weight, bias, gn) -> torch.Tensor:
    b, h, w, cin = x.shape
    cout = weight.shape[0]
    is_bf16 = int(x.dtype == torch.bfloat16)
    kernel, workspace = _kernel()
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    # fp32 partial sums and zeroed tile counters where the kernel splits K
    # over blocks
    n_counters = ctypes.c_longlong(0)
    n_ws = workspace(b, h, w, cin, cout, is_bf16, ctypes.byref(n_counters))
    ws = counters = None
    if n_ws:
        ws = torch.empty(n_ws, dtype=torch.float32, device=x.device)
        counters = torch.zeros(n_counters.value, dtype=torch.int32,
                               device=x.device)
    mean, rstd, gamma, beta = gn if gn is not None else (None,) * 4
    groups = mean.shape[1] if gn is not None else 0
    ptr = (lambda t: None if t is None else t.data_ptr())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = kernel(x.data_ptr(), weight.data_ptr(), ptr(bias), ptr(mean),
                 ptr(rstd), ptr(gamma), ptr(beta), out.data_ptr(), ptr(ws),
                 ptr(counters), is_bf16, b, h, w, cin, cout, groups, stream)
    if err != 0:
        raise RuntimeError(f"conv3x3 kernel launch failed: CUDA error {err}")
    return out


def conv3x3(x: torch.Tensor, weight: torch.Tensor,
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """conv3x3(x) + bias, stride 1, SAME: x (B, H, W, Cin), weight
    (Cout, Cin, 3, 3), bias (Cout,) -> (B, H, W, Cout) in x's dtype."""
    if sequence.current() is not None:
        return sequence.with_halo(x, lambda xe: _conv3x3(xe, weight, bias))
    if needs_grad(x, weight, bias):
        return Conv3x3.apply({}, x, weight, bias)
    return _conv3x3(x, weight, bias)


def _conv3x3(x, weight, bias=None):
    if not x.is_cuda:
        return conv3x3_plain(x, weight, bias)
    _check("conv3x3", x, weight, bias)
    out = _launch(x, weight, bias, None)
    conv3x3.launches += 1
    return out


def conv3x3_gn_silu(x: torch.Tensor, weight: torch.Tensor,
                    bias: Optional[torch.Tensor], gamma: torch.Tensor,
                    beta: torch.Tensor, *, num_groups: int,
                    eps: float) -> torch.Tensor:
    """conv3x3(silu(group_norm(x))) + bias with per-(batch, group) fp32
    statistics; gamma and beta are (Cin,) fp32."""
    if sequence.current() is not None:
        stats = group_norm_stats(x, num_groups, eps)  # the canvas's
        return sequence.with_halo(x, lambda xe: _conv3x3_gn_silu(
            xe, weight, bias, gamma, beta, num_groups=num_groups, eps=eps,
            stats=stats))
    if needs_grad(x, weight, bias, gamma, beta):
        return Conv3x3GnSilu.apply(dict(num_groups=num_groups, eps=eps),
                                   x, weight, bias, gamma, beta)
    return _conv3x3_gn_silu(x, weight, bias, gamma, beta,
                            num_groups=num_groups, eps=eps)


def _conv3x3_gn_silu(x, weight, bias, gamma, beta, *, num_groups, eps,
                     stats=None):
    if not x.is_cuda:
        return conv3x3_gn_silu_plain(x, weight, bias, gamma, beta,
                                     num_groups=num_groups, eps=eps,
                                     stats=stats)
    _check("conv3x3_gn_silu", x, weight, bias)
    cin = x.shape[-1]
    for t in (gamma, beta):
        if t.shape != (cin,) or t.dtype != torch.float32 or \
                t.device != x.device or not t.is_contiguous():
            raise ValueError(f"conv3x3_gn_silu: gamma/beta must be ({cin},) "
                             f"fp32 on {x.device}")
    mean, rstd = stats if stats is not None else group_norm_stats(
        x, num_groups, eps)
    out = _launch(x, weight, bias, (mean, rstd, gamma, beta))
    conv3x3_gn_silu.launches += 1
    return out


Conv3x3 = recompute_function("Conv3x3", _conv3x3, conv3x3_plain)
Conv3x3GnSilu = recompute_function("Conv3x3GnSilu", _conv3x3_gn_silu,
                                   conv3x3_gn_silu_plain)
conv3x3.launches = 0
conv3x3_gn_silu.launches = 0


# ---------------------------------------------------------------------------
# static-scale int8 W8A8 (the JAX package's POWERPAINT_INT8 path)
#
# ``conv3x3_gn_silu_int8`` and ``conv3x3_int8`` compute the functions of the
# TPU kernels ``conv_pallas.py::_int8_fused_kernel`` and ``_int8_kernel``:
# the activation (post-SiLU in fp32, or x itself) quantised with one static
# per-tensor scale, q = clip(round_half_even(y * (1 / x_scale)), -127, 127);
# int8 weights with one scale per output channel (``quantize_weights_int8``);
# exact int32 sums; out = acc * (w_scale * x_scale) + bias in fp32, then x's
# dtype. On the card each is two launches: the quantiser of
# ``ops.norms`` (``gn_silu_quantize_int8``, one launch with its GroupNorm
# statistics at the UNet's maps; or ``quantize_int8``), then the int8
# implicit GEMM ``csrc/conv3x3_int8.cu`` (wgmma s8 fed by TMA) on the
# quantised activation. ``int8_site`` is the JAX package's rule for which
# ResNet units run quantised; the others keep the bf16 kernel above.
# ---------------------------------------------------------------------------


def quantize_weights_int8(weight: torch.Tensor):
    """Per-output-channel symmetric int8 of an OIHW (Cout, Cin, 3, 3) weight,
    as ``conv_pallas.quantize_weights_int8``: absmax over (Cin, kh, kw),
    ``scale = max(absmax, 1e-8) / 127``, ``w_q = clip(round(w / scale))``.
    Returns w_q int8 (Cout, 3, 3, Cin) contiguous, the layout the kernel
    reads, and the fp32 (Cout,) scale."""
    wf = weight.float()
    scale = torch.clamp(wf.abs().amax(dim=(1, 2, 3)), min=1e-8) / 127.0
    w_q = torch.clamp(torch.round(wf / scale[:, None, None, None]), -127, 127)
    return w_q.to(torch.int8).permute(0, 2, 3, 1).contiguous(), scale


def _int8_product_plain(q: torch.Tensor, w_q: torch.Tensor,
                        w_scale: torch.Tensor, bias: Optional[torch.Tensor],
                        x_scale: float, dtype: torch.dtype) -> torch.Tensor:
    """The int8 products of quantised NHWC ``q`` summed exactly (float64
    holds every int32 sum), dequantised in fp32, cast to ``dtype``."""
    acc = F.conv2d(q.permute(0, 3, 1, 2).double(),
                   w_q.permute(0, 3, 1, 2).double(), padding=1)
    out = acc.permute(0, 2, 3, 1).float() * (w_scale.float() * float(x_scale))
    if bias is not None:
        out = out + bias.float()
    return out.to(dtype)


def conv3x3_int8_plain(x: torch.Tensor, w_q: torch.Tensor,
                       w_scale: torch.Tensor, bias: Optional[torch.Tensor], *,
                       x_scale: float) -> torch.Tensor:
    """``conv3x3_int8`` in plain PyTorch: x itself is quantised."""
    q = quantize_int8_plain(x, x_scale=x_scale)
    return _int8_product_plain(q, w_q, w_scale, bias, x_scale, x.dtype)


def conv3x3_gn_silu_int8_plain(x: torch.Tensor, w_q: torch.Tensor,
                               w_scale: torch.Tensor,
                               bias: Optional[torch.Tensor],
                               gamma: torch.Tensor, beta: torch.Tensor, *,
                               x_scale: float, num_groups: int,
                               eps: float, stats=None) -> torch.Tensor:
    """``conv3x3_gn_silu_int8`` in plain PyTorch."""
    q = gn_silu_quantize_int8_plain(x, gamma, beta, num_groups=num_groups,
                                    eps=eps, x_scale=x_scale, stats=stats)
    return _int8_product_plain(q, w_q, w_scale, bias, x_scale, x.dtype)


def int8_plan(b: int, h: int, w: int, cin: int, cout: int,
              sms: int = 132) -> dict:
    """How the int8 kernel cuts a shape, as ``plan_int8`` in
    ``csrc/conv3x3_int8.cu`` does it (a card test holds the two together):
    ``bf16_plan``'s 8 x 8 pixel tiles, Cout tiles and clock estimate, over
    128-channel K chunks, with the K split (a cluster of blocks) one of 1,
    2, 4 or 8; never from ``b``."""
    tiles_img = -(-h // 8) * -(-w // 8)
    n_chunks = -(-cin // 128)
    options = (256, 160, 128, 64)
    least = min(-(-cout // n) * n for n in options)
    best = None
    for bn in options:
        n_tiles = -(-cout // bn)
        if n_tiles * bn > least:
            continue
        t_mma = max(bn / 2.0, 16.0 + bn / 4.0)
        want = 1
        while want <= 8 and want <= n_chunks:
            per = -(-n_chunks // want)
            splits = -(-n_chunks // per)
            if splits == want:
                waves = float(-(-(tiles_img * n_tiles * splits) // sms))
                cost = waves * (per * 72.0 * t_mma + 6000.0 +
                                (12.0 * splits * bn if splits > 1 else 0.0))
                if best is None or cost < best[0]:
                    best = (cost, bn, n_tiles, per, splits)
            want *= 2
    _, bn, n_tiles, per, splits = best
    stages = min(8, 160 * 1024 // (bn * 128))
    smem = 1024 + 2 * 2 * 13 * 1024 + stages * bn * 128 + 8 * (4 + 2 * stages)
    return dict(bn=bn, tiles=b * tiles_img, blocks=-(-(b * tiles_img) // 2),
                n_tiles=n_tiles, splits=splits, per=per, smem=smem)


@functools.lru_cache(maxsize=None)
def _int8_kernel():
    fn = _build.load("conv3x3_int8").ppt_conv3x3_int8
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_float]
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    return fn


def _check_int8(name, x, w_q, w_scale, bias):
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{name} takes a contiguous (B, H, W, C) tensor")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name} takes fp32 or bf16, got {x.dtype}")
    cout = w_q.shape[0]
    if w_q.dtype != torch.int8 or w_q.shape != (cout, 3, 3, x.shape[-1]) or \
            not w_q.is_contiguous():
        raise ValueError(f"{name}: w_q must be contiguous int8 (Cout, 3, 3, "
                         f"{x.shape[-1]}), got {w_q.dtype} {tuple(w_q.shape)}")
    for t in (w_scale, bias):
        if t is not None and (t.shape != (cout,) or t.dtype != torch.float32
                              or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"{name}: w_scale and bias must be ({cout},) fp32 "
                             f"on {x.device}")
    if w_q.device != x.device:
        raise ValueError(f"{name}: w_q must be on {x.device}")


def int8_product(q: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                 bias: Optional[torch.Tensor], x_scale: float,
                 dtype: torch.dtype) -> torch.Tensor:
    """The int8 conv kernel alone on a quantised (B, H, W, Cin) int8
    activation on the card -> (B, H, W, Cout) in ``dtype``: the second
    launch of the int8 units (not counted; the units count themselves).
    A Cin off 16 (test shapes only) is padded with zero channels, which
    the TMA strides need and which add nothing to the sums."""
    b, h, w, cin = q.shape
    cout = w_q.shape[0]
    if cin % 16:
        pad = 16 - cin % 16
        q = F.pad(q, (0, pad)).contiguous()
        w_q = F.pad(w_q, (0, pad)).contiguous()
        cin += pad
    out = torch.empty((b, h, w, cout), dtype=dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _int8_kernel()(q.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(),
                         None if bias is None else bias.data_ptr(),
                         out.data_ptr(), float(x_scale),
                         int(dtype == torch.bfloat16), b, h, w, cin, cout,
                         stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_int8 kernel launch failed: CUDA error {err}")
    return out


def conv3x3_int8(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, *,
                 x_scale: float) -> torch.Tensor:
    """conv3x3(quantise(x)) with int8 products: x (B, H, W, Cin) fp32 or
    bf16, w_q int8 (Cout, 3, 3, Cin), w_scale and bias fp32 (Cout,) ->
    (B, H, W, Cout) in x's dtype."""
    if sequence.current() is not None:
        return sequence.with_halo(x, lambda xe: _conv3x3_int8(
            xe, w_q, w_scale, bias, x_scale=x_scale))
    return _conv3x3_int8(x, w_q, w_scale, bias, x_scale=x_scale)


def _conv3x3_int8(x, w_q, w_scale, bias, *, x_scale):
    if not x.is_cuda:
        return conv3x3_int8_plain(x, w_q, w_scale, bias, x_scale=x_scale)
    _check_int8("conv3x3_int8", x, w_q, w_scale, bias)
    q = quantize_int8(x, x_scale=x_scale)
    out = int8_product(q, w_q, w_scale, bias, x_scale, x.dtype)
    conv3x3_int8.launches += 1
    return out


def conv3x3_gn_silu_int8(x: torch.Tensor, w_q: torch.Tensor,
                         w_scale: torch.Tensor, bias: Optional[torch.Tensor],
                         gamma: torch.Tensor, beta: torch.Tensor, *,
                         x_scale: float, num_groups: int,
                         eps: float) -> torch.Tensor:
    """conv3x3(quantise(silu(group_norm(x)))) with int8 products; gamma and
    beta are (Cin,) fp32, the other arguments as ``conv3x3_int8``."""
    kw = dict(x_scale=x_scale, num_groups=num_groups, eps=eps)
    if sequence.current() is not None:
        stats = group_norm_stats(x, num_groups, eps)  # the canvas's
        return sequence.with_halo(x, lambda xe: _conv3x3_gn_silu_int8(
            xe, w_q, w_scale, bias, gamma, beta, stats=stats, **kw))
    return _conv3x3_gn_silu_int8(x, w_q, w_scale, bias, gamma, beta, **kw)


def _conv3x3_gn_silu_int8(x, w_q, w_scale, bias, gamma, beta, *, x_scale,
                          num_groups, eps, stats=None):
    if not x.is_cuda:
        return conv3x3_gn_silu_int8_plain(
            x, w_q, w_scale, bias, gamma, beta, x_scale=x_scale,
            num_groups=num_groups, eps=eps, stats=stats)
    _check_int8("conv3x3_gn_silu_int8", x, w_q, w_scale, bias)
    cin = x.shape[-1]
    for t in (gamma, beta):
        if t.shape != (cin,) or t.dtype != torch.float32 or \
                t.device != x.device or not t.is_contiguous():
            raise ValueError(f"conv3x3_gn_silu_int8: gamma/beta must be "
                             f"({cin},) fp32 on {x.device}")
    q = gn_silu_quantize_int8(x, gamma, beta, num_groups=num_groups, eps=eps,
                              x_scale=x_scale, stats=stats)
    out = int8_product(q, w_q, w_scale, bias, x_scale, x.dtype)
    conv3x3_gn_silu_int8.launches += 1
    return out


conv3x3_int8.launches = 0
conv3x3_gn_silu_int8.launches = 0


@functools.lru_cache(maxsize=None)
def int8_site(h: int, w: int, cin: int, cout: int) -> bool:
    """Whether the JAX package quantises the ResNet unit (GroupNorm + SiLU
    -> 3x3 conv, Cin -> Cout at an H x W map) when int8 is on.

    The JAX package runs ``conv3x3_gn_silu_int8`` only where its TPU
    kernel's scoped-VMEM model admits the shape (``conv_pallas.py::
    int8_fused_feasible`` with ``_pick_tiles``, ``_padded_w``,
    ``_padded_c``; the batch does not enter), and the bf16 chain elsewhere.
    That gate therefore decides which layers are quantised, and so the
    image: the port keeps its arithmetic, copied here, so that int8 on the
    card quantises the same layers. At a 512 x 512 image it admits every
    UNet and BrushNet unit but the 32 x 32 up-block ``norm1`` sites, and of
    the VAE only (256, 128 -> 256) and (128, 256 -> 512)."""
    wp = ((w + 2 + 7) // 8) * 8                    # slab width, 8-row tiles
    cp = ((cin + 127) // 128) * 128                # 128-lane channels
    budget = 10 * 1024 * 1024
    tn = cout                                      # _pick_tiles
    for cand in sorted({d for d in range(128, cout, 128) if cout % d == 0},
                       reverse=True):
        if 9 * cp * tn * 2 <= budget // 3:
            break
        tn = cand
    th = h
    while th > 4:
        if ((th + 2) * wp * cp * 2 + th * w * tn * 4 + 9 * cp * tn * 2
                + th * w * tn * 2) <= budget:
            break
        th //= 2
    use = ((th + 2) * wp * cp * 15 + 9 * cp * tn + th * w * tn * 4
           + th * w * tn * 2)
    return use <= 20 * 1024 * 1024
