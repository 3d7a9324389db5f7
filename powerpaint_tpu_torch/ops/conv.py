"""3x3 stride-1 SAME convolution on NHWC tensors, with or without a
GroupNorm + SiLU prologue.

``conv3x3_gn_silu`` computes ``conv3x3(silu(group_norm(x))) + bias`` and
``conv3x3`` computes ``conv3x3(x) + bias``: the functions of the TPU kernels
``powerpaint_tpu/ops/conv_pallas.py::_fused_kernel`` and ``_plain_kernel``.
Both wrap one hand-written CUDA kernel, ``csrc/conv3x3.cu`` (an implicit
GEMM on the tensor cores, the prologue a compile-time flag); the GroupNorm
statistics come first from ``ops.norms.group_norm_stats``, so a ResNet unit
costs two Triton launches and one conv launch, and the normalised activation
never goes through device memory. What bounds the kernel and what its design
does about it is written at the top of the ``.cu`` source.

Activations are (B, H, W, C) and the weight is PyTorch's (Cout, Cin, 3, 3);
the kernel reads it as (Cout, 3, 3, Cin), which is that weight in
channels-last memory, the format ``io.weights.load_models`` stores every
conv weight in. For a CUDA tensor each wrapper launches the kernel or
raises; for a CPU tensor it runs its ``*_plain`` version (GroupNorm then
``F.conv2d``), which is also the kernel's oracle.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from powerpaint_tpu_torch.ops import _build
from powerpaint_tpu_torch.ops.norms import group_norm_plain, group_norm_stats


def conv3x3_plain(x: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``F.conv2d`` with padding 1 on the NCHW view of NHWC ``x``."""
    return F.conv2d(x.permute(0, 3, 1, 2), weight, bias,
                    padding=1).permute(0, 2, 3, 1)


def conv3x3_gn_silu_plain(x: torch.Tensor, weight: torch.Tensor,
                          bias: Optional[torch.Tensor], gamma: torch.Tensor,
                          beta: torch.Tensor, *, num_groups: int,
                          eps: float) -> torch.Tensor:
    """GroupNorm + SiLU in fp32, rounded to x's dtype, then the conv."""
    h = group_norm_plain(x, gamma, beta, num_groups=num_groups, eps=eps,
                         silu=True)
    return conv3x3_plain(h, weight, bias)


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
    if not x.is_cuda:
        return conv3x3_gn_silu_plain(x, weight, bias, gamma, beta,
                                     num_groups=num_groups, eps=eps)
    _check("conv3x3_gn_silu", x, weight, bias)
    cin = x.shape[-1]
    for t in (gamma, beta):
        if t.shape != (cin,) or t.dtype != torch.float32 or \
                t.device != x.device or not t.is_contiguous():
            raise ValueError(f"conv3x3_gn_silu: gamma/beta must be ({cin},) "
                             f"fp32 on {x.device}")
    mean, rstd = group_norm_stats(x, num_groups, eps)
    out = _launch(x, weight, bias, (mean, rstd, gamma, beta))
    conv3x3_gn_silu.launches += 1
    return out


conv3x3.launches = 0
conv3x3_gn_silu.launches = 0
