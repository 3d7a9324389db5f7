"""The control of the correctness check: the plain reference put in the
served system's place and computed one precision below what the
configuration states. The configuration computes in bf16; the step below
is fp8 (e4m3, the card's fp8 tensor-core format): inside ``fp8_operands``
every operand of a convolution, a linear layer and an attention product
is rounded to e4m3 with a scale of its own (its largest magnitude over
448, e4m3's largest value) and the product is taken in float32, as an fp8
GEMM with float32 accumulation computes it. Norms, softmax, the samplers
and the VAE sample stay in float32."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 at a per-tensor scale, back in float32."""
    scale = x.detach().abs().amax().clamp(min=1e-12) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


@contextlib.contextmanager
def fp8_operands():
    conv2d, linear, matmul = F.conv2d, F.linear, torch.matmul

    def conv2d_fp8(input, weight, bias=None, *args, **kwargs):
        return conv2d(fp8(input), fp8(weight), bias, *args, **kwargs)

    def linear_fp8(input, weight, bias=None):
        return linear(fp8(input), fp8(weight), bias)

    def matmul_fp8(a, b):
        return matmul(fp8(a), fp8(b))

    F.conv2d, F.linear, torch.matmul = conv2d_fp8, linear_fp8, matmul_fp8
    try:
        yield
    finally:
        F.conv2d, F.linear, torch.matmul = conv2d, linear, matmul
