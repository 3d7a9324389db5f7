#!/usr/bin/env python3
"""Drive the PyTorch port (``powerpaint_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. The card (``nvidia-smi`` name and power limit), the torch / CUDA / Triton
   versions, then the build of the CUDA sources in
   ``powerpaint_tpu_torch/csrc`` (one nvcc each, started together) with its
   time.
2. Kernel checks: each kernel of the main paths (flash attention, the 3x3
   conv with and without its GroupNorm+SiLU prologue and its static-scale
   int8 form, all in CUDA; GroupNorm(+SiLU) and LayerNorm in Triton)
   against its plain PyTorch version at the main paths' shapes, in fp32
   (TF32 off for matmuls and convs) and in bf16, and timed beside the plain
   version, one PyTorch library call of the same function, and the
   data-sheet bound. A kernel's ``ms`` and the library call's are device
   time (a CUDA graph of 20 calls replayed), ``stream_ms`` the same calls
   enqueued one by one (the host's pace where it is the slower),
   ``host_ms`` the host's enqueue alone. Then each kernel's batch
   invariance: a CFG batch of two requests (4 images) against one request
   (2 images), and the same for the cuBLAS and cuDNN calls the paths make.
3. The ppt-v1 path: full width (860M-parameter 9-channel UNet, SD1.5 VAE,
   CLIP ViT-L/14 text with 30 task-token rows), random weights from a
   seed, bf16, a 512x512 image: the four tasks at 20 DDIM steps with
   guidance 7.5, the same seed twice, another seed, a two-request batch and
   one call with strength 0.6 and eta 0.5.
4. The ppt-v2 path: full width (the SD1.5 base UNet with 4 input channels,
   a BrushNet branch of the same widths with 28 taps, the SD1.5 VAE, two
   CLIP ViT-L/14 towers), random bf16 weights from a seed, 512x512, UniPC,
   guidance 7.5: the four tasks at 20 steps, the same seed twice, another
   seed, a two-request batch, conditioning scale 0 (which must change the
   image), control_guidance_end 0.5, guess mode, and one call at 45 steps.
   In both paths each call must launch every kernel the number of times
   the config implies and the latents before decode must be finite; each
   path ends with one profiled call.
5. The int8 W8A8 paths (``POWERPAINT_INT8=1``, default x_scale): ppt-v1
   at 20 DDIM steps (two tasks, the same seed twice, a two-request batch)
   and ppt-v2 at 20 UniPC steps (one task and a repeat). Each call must
   launch the int8 kernel exactly at the ResNet units the JAX package's
   site rule (``ops.conv.int8_site``) quantises and the bf16 fused kernel
   at the rest; the script prints seconds per image, the PSNR of each int8
   image against the bf16 image of the same seed, and the share of
   post-SiLU activations the static scale saturates in one call's first
   step.
6. The command line, ``serve.cli.main`` in this process: ppt-v1 with int8
   on, a 512x512 PNG and mask written by the script, 20 steps, its launch
   counts, the PNG it writes and its output line.
7. Tiny configurations (ppt-v1, ppt-v2, ppt-v1 with int8) must give the
   same image through the kernels as through the plain versions on the
   CPU.
8. The ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

With no GPU the script fails before printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# Data-sheet peaks of an H100 SXM at its 700 W limit (NVIDIA): dense bf16
# and int8 tensor-core rates and HBM3 bandwidth. Bounds below are
# arithmetic on these, not measurements.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12

STEPS = 20
GUIDANCE = 7.5
HW = 512
TASKS = ("text-guided", "object-removal", "shape-guided", "image-outpainting")


def log(**fields) -> None:
    print(json.dumps(fields), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of one call on the stream, from CUDA events around
    ``iters`` back-to-back calls after ``warmup`` calls. Where the host
    enqueues a call more slowly than the card runs it, this is the host's
    pace (``graph_ms`` is the device's)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20) -> float:
    """Mean device time of one call with no host in the way: ``iters``
    calls captured in one CUDA graph, its replay timed with CUDA events."""
    fn()  # builds, specialises and allocates outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean host time to enqueue one call (the wrapper's Python and launch
    cost), on the host clock with no synchronisation inside the loop."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t * 1e3 / iters


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    """Least time on the card for the work: the larger of bytes over the
    memory rate and operations over the tensor-core rate of their type
    (bf16 unless ``peak`` says otherwise)."""
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

# (B, Sq, Skv, N, D): UNet self-attention at the four latent levels of a
# 512x512 image under CFG (batch 2), the cross-attention to 77 text tokens
# at each level, and the VAE's one-head mid attention (batch 1).
ATTN_SHAPES = [
    (2, 4096, 4096, 8, 40), (2, 1024, 1024, 8, 80), (2, 256, 256, 8, 160),
    (2, 64, 64, 8, 160),
    (2, 4096, 77, 8, 40), (2, 1024, 77, 8, 80), (2, 256, 77, 8, 160),
    (2, 64, 77, 8, 160),
    (1, 4096, 4096, 1, 512),
]
# (shape (B, S, C), eps, silu): ResNet norms at each UNet level, the widest
# up-block concat, the transformer input norm, and the VAE's largest maps.
GN_SHAPES = [
    ((2, 4096, 320), 1e-5, True), ((2, 4096, 960), 1e-5, True),
    ((2, 1024, 640), 1e-5, True), ((2, 256, 1280), 1e-5, True),
    ((2, 64, 2560), 1e-5, True), ((2, 4096, 320), 1e-6, False),
    ((1, 262144, 128), 1e-6, True), ((1, 65536, 256), 1e-6, True),
    ((1, 4096, 512), 1e-6, False),
]
# (B, H, W, Cin, Cout, groups): ResNet units (conv3x3_gn_silu) of the UNet
# and the BrushNet at a 512x512 image under CFG (the first level, the
# widest up-block concats, the deep levels) and of the VAE at its largest
# map; upsampler convs (conv3x3, no groups) of the UNet and the VAE
# decoder, and the first UNet level's shape without the prologue (what the
# prologue costs there); then a ragged fp32-only shape for each (groups of
# 2 channels, Cin and Cout off the tiles). The first row of each is the one
# the kernels line reports.
CONV_SHAPES = {
    "conv3x3_gn_silu": [
        (2, 64, 64, 320, 320, 32), (2, 64, 64, 960, 320, 32),
        (2, 16, 16, 2560, 1280, 32), (2, 8, 8, 1280, 1280, 32),
        (1, 512, 512, 128, 128, 32), (1, 8, 8, 48, 40, 24)],
    "conv3x3": [
        (2, 64, 64, 640, 640, 0), (2, 16, 16, 1280, 1280, 0),
        (1, 512, 512, 256, 256, 0), (2, 64, 64, 320, 320, 0),
        (1, 8, 8, 48, 40, 0)],
}
# (B, H, W, Cin, Cout, groups): the int8 form (with and without the
# prologue) at ResNet units the JAX package quantises at a 512x512 image:
# the UNet's first level, its widest int8 up-block concat, the deep levels,
# and the VAE encoder's (256, 128 -> 256); then a ragged fp32-only shape.
INT8_SHAPES = [(2, 64, 64, 320, 320, 32), (2, 64, 64, 960, 320, 32),
               (2, 16, 16, 2560, 1280, 32), (2, 8, 8, 1280, 1280, 32),
               (1, 256, 256, 128, 256, 32), (1, 5, 7, 20, 12, 10)]
X_SCALE = 8.0 / 127.0  # the JAX package's default POWERPAINT_INT8_XSCALE
# (shape, eps): transformer-block norms at each UNet level and CLIP's.
LN_SHAPES = [
    ((2, 4096, 320), 1e-5), ((2, 1024, 640), 1e-5), ((2, 256, 1280), 1e-5),
    ((2, 64, 1280), 1e-5), ((4, 77, 768), 1e-5),
]

# Tolerances. fp32: the kernels and the plain versions do the same fp32
# arithmetic in another order (attention over up to 4096 terms, norms over
# up to 33M), so they agree to a few fp32 rounding steps: 1e-4 absolute on
# outputs of size ~1. bf16: both round the result to bf16 once; where the
# fp32 values straddle a rounding boundary they differ by one bf16 step, at
# most 2^-7 of the largest output; 1e-2 more covers the plain attention's
# rounding of the probabilities to bf16 before P @ V (the JAX package's
# convention), where the kernel keeps them in fp32.
def tolerance(dtype: torch.dtype, ref: torch.Tensor) -> float:
    if dtype == torch.float32:
        return 1e-4
    return 2.0 ** -7 * float(ref.float().abs().max()) + 1e-2


def check_kernels(device) -> list:
    from powerpaint_tpu_torch.ops import conv
    from powerpaint_tpu_torch.ops import flash_attention as fa
    from powerpaint_tpu_torch.ops import norms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(1234)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    summary = {}

    def record(name, shape, dtype, err, tol, ok=None, **extra):
        log(check=name, shape=list(shape), dtype=str(dtype).split(".")[-1],
            max_abs_err=err, tol=tol, **extra)
        ok = err <= tol if ok is None else ok
        check(ok, f"{name} {shape} {dtype}: max |err| {err} beyond {tol}")
        s = summary.setdefault(name, {"max_abs_err": 0.0, "checks": 0})
        s["max_abs_err"] = max(s["max_abs_err"], err)
        s["checks"] += 1

    timings = {}

    # ---- kernel 1: flash attention
    t0 = time.perf_counter()
    for (b, sq, skv, n, d) in ATTN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q = randn(b, sq, n, d, dtype=dtype)
            k = randn(b, skv, n, d, dtype=dtype)
            v = randn(b, skv, n, d, dtype=dtype)
            got = fa.flash_attention(q, k, v)
            torch.cuda.synchronize()
            want = fa.flash_attention_plain(q, k, v)
            err = float((got.float() - want.float()).abs().max())
            record("flash_attention", (b, sq, skv, n, d), dtype, err,
                   tolerance(dtype, want))
            if dtype != torch.bfloat16:
                continue
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            flops = 4.0 * b * n * sq * skv * d
            nbytes = 2.0 * (2 * b * sq * n * d + 2 * b * skv * n * d)
            timings.setdefault("flash_attention", []).append(dict(
                shape=[b, sq, skv, n, d],
                ms=graph_ms(lambda: fa.flash_attention(q, k, v)),
                stream_ms=cuda_ms(lambda: fa.flash_attention(q, k, v)),
                host_ms=host_ms(lambda: fa.flash_attention(q, k, v)),
                plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v),
                                 iters=5),
                library_ms=graph_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        qt, kt, vt)),
                bound=bound_ms(flops, nbytes)))
    log(phase="kernel checks", kernel="flash_attention",
        seconds=time.perf_counter() - t0)

    # ---- kernel 2: GroupNorm (+ SiLU)
    t0 = time.perf_counter()
    for shape, eps, silu in GN_SHAPES:
        c = shape[-1]
        for dtype in (torch.float32, torch.bfloat16):
            x = (randn(*shape) * 2 - 0.3).to(dtype)
            w = 1 + 0.1 * randn(c)
            bb = 0.1 * randn(c)
            kw = dict(num_groups=32, eps=eps, silu=silu)
            got = norms.group_norm(x, w, bb, **kw)
            torch.cuda.synchronize()
            want = norms.group_norm_plain(x, w, bb, **kw)
            err = float((got.float() - want.float()).abs().max())
            record("group_norm", shape, dtype, err, tolerance(dtype, want))
            if dtype != torch.bfloat16:
                continue
            # cuDNN's / ATen's NCHW group norm on the channels-last view
            x_nchw = x.reshape(shape[0], -1, 1, c).permute(0, 3, 1, 2)
            wl, bl = w.to(dtype), bb.to(dtype)

            def library(x_nchw=x_nchw, wl=wl, bl=bl, eps=eps, silu=silu):
                y = torch.nn.functional.group_norm(x_nchw, 32, wl, bl, eps)
                return torch.nn.functional.silu(y) if silu else y

            nbytes = 2.0 * 2 * x.numel()
            timings.setdefault("group_norm", []).append(dict(
                shape=list(shape), silu=silu,
                ms=graph_ms(lambda: norms.group_norm(x, w, bb, **kw)),
                stream_ms=cuda_ms(lambda: norms.group_norm(x, w, bb, **kw)),
                host_ms=host_ms(lambda: norms.group_norm(x, w, bb, **kw)),
                plain_ms=cuda_ms(lambda: norms.group_norm_plain(x, w, bb, **kw)),
                library_ms=graph_ms(library),
                bound=bound_ms(0.0, nbytes)))
    log(phase="kernel checks", kernel="group_norm",
        seconds=time.perf_counter() - t0)

    # ---- kernel 3: LayerNorm
    t0 = time.perf_counter()
    for shape, eps in LN_SHAPES:
        c = shape[-1]
        for dtype in (torch.float32, torch.bfloat16):
            x = (randn(*shape) * 3 + 0.5).to(dtype)
            w = 1 + 0.1 * randn(c)
            bb = 0.1 * randn(c)
            got = norms.layer_norm(x, w, bb, eps=eps)
            torch.cuda.synchronize()
            want = norms.layer_norm_plain(x, w, bb, eps=eps)
            err = float((got.float() - want.float()).abs().max())
            record("layer_norm", shape, dtype, err, tolerance(dtype, want))
            if dtype != torch.bfloat16:
                continue
            wl, bl = w.to(dtype), bb.to(dtype)
            nbytes = 2.0 * 2 * x.numel()
            timings.setdefault("layer_norm", []).append(dict(
                shape=list(shape),
                ms=graph_ms(lambda: norms.layer_norm(x, w, bb, eps=eps)),
                stream_ms=cuda_ms(lambda: norms.layer_norm(x, w, bb, eps=eps)),
                host_ms=host_ms(lambda: norms.layer_norm(x, w, bb, eps=eps)),
                plain_ms=cuda_ms(lambda: norms.layer_norm_plain(x, w, bb, eps=eps)),
                library_ms=graph_ms(lambda: torch.nn.functional.layer_norm(
                    x, (c,), wl, bl, eps)),
                bound=bound_ms(0.0, nbytes)))
    log(phase="kernel checks", kernel="layer_norm",
        seconds=time.perf_counter() - t0)

    # ---- kernels 4 and 5: 3x3 conv with / without the GN+SiLU prologue
    t0 = time.perf_counter()
    F = torch.nn.functional
    for name, shapes in CONV_SHAPES.items():
        fused = name == "conv3x3_gn_silu"
        for (b, h, w, cin, cout, groups) in shapes:
            dtypes = (torch.float32,) if cin == 48 else (torch.float32,
                                                         torch.bfloat16)
            for dtype in dtypes:
                x = (randn(b, h, w, cin) * 2 - 0.3).to(dtype)
                wt = (randn(cout, cin, 3, 3) / (3 * cin ** 0.5)).to(dtype)
                wt = wt.contiguous(memory_format=torch.channels_last)
                bias = (0.1 * randn(cout)).to(dtype)
                gamma = 1 + 0.1 * randn(cin)
                beta = 0.5 + 0.1 * randn(cin)  # large: a nonzero SAME pad shows
                kw = dict(num_groups=groups, eps=1e-5)
                if fused:
                    fn = lambda: conv.conv3x3_gn_silu(x, wt, bias, gamma, beta, **kw)
                    ref = lambda: conv.conv3x3_gn_silu_plain(x, wt, bias, gamma,
                                                             beta, **kw)
                else:
                    fn = lambda: conv.conv3x3(x, wt, bias)
                    ref = lambda: conv.conv3x3_plain(x, wt, bias)
                got = fn()
                torch.cuda.synchronize()
                want = ref()
                err = float((got.float() - want.float()).abs().max())
                record(name, (b, h, w, cin, cout), dtype, err,
                       tolerance(dtype, want))
                if dtype != torch.bfloat16:
                    continue
                # cuDNN on the channels-last NCHW view, ATen's group norm
                x_nchw = x.permute(0, 3, 1, 2)
                gl, bl = gamma.to(dtype), beta.to(dtype)

                def library(x_nchw=x_nchw, wt=wt, bias=bias, gl=gl, bl=bl,
                            groups=groups, fused=fused):
                    y = x_nchw
                    if fused:
                        y = F.silu(F.group_norm(y, groups, gl, bl, 1e-5))
                    return F.conv2d(y, wt, bias, padding=1)

                flops = 2.0 * b * h * w * 9 * cin * cout
                nbytes = 2.0 * (b * h * w * (cin + cout) + 9 * cin * cout + cout)
                if fused:
                    nbytes += 8.0 * cin  # gamma, beta in fp32
                iters = 5 if h * w >= 512 * 512 else 20
                timings.setdefault(name, []).append(dict(
                    shape=[b, h, w, cin, cout],
                    ms=graph_ms(fn, iters=iters),
                    stream_ms=cuda_ms(fn, iters=iters),
                    host_ms=host_ms(fn, iters=iters),
                    plain_ms=cuda_ms(ref, iters=iters),
                    library_ms=graph_ms(library, iters=iters),
                    bound=bound_ms(flops, nbytes)))
    log(phase="kernel checks", kernel="conv3x3", seconds=time.perf_counter() - t0)

    # ---- kernels 6 and 7: the static-scale int8 conv with / without the
    # GN+SiLU prologue
    t0 = time.perf_counter()
    for (b, h, w, cin, cout, groups) in INT8_SHAPES:
        dtypes = (torch.float32,) if cin == 20 else (torch.float32,
                                                     torch.bfloat16)
        for fused in (True, False):
            name = "conv3x3_gn_silu_int8" if fused else "conv3x3_int8"
            for dtype in dtypes:
                x = (randn(b, h, w, cin) * 2 - 0.3).to(dtype)
                x_other = (randn(1, h, w, cin) * 2 - 0.3).to(dtype)
                w_q, w_s = conv.quantize_weights_int8(
                    randn(cout, cin, 3, 3) / (3 * cin ** 0.5))
                bias = 0.1 * randn(cout)
                gamma = 1 + 0.1 * randn(cin)
                beta = 0.5 + 0.1 * randn(cin)  # large: a nonzero SAME pad shows
                kw = dict(x_scale=X_SCALE)
                gn = (gamma, beta)
                if fused:
                    kw.update(num_groups=groups, eps=1e-5)
                    fn = lambda x=x: conv.conv3x3_gn_silu_int8(
                        x, w_q, w_s, bias, *gn, **kw)
                    ref = lambda: conv.conv3x3_gn_silu_int8_plain(
                        x, w_q, w_s, bias, *gn, **kw)
                else:
                    fn = lambda x=x: conv.conv3x3_int8(x, w_q, w_s, bias, **kw)
                    ref = lambda: conv.conv3x3_int8_plain(x, w_q, w_s, bias, **kw)
                got = fn()
                again = fn()
                torch.cuda.synchronize()
                want = ref()
                err, ok, flips = int8_check(got, want, x, w_q, w_s, bias,
                                            fused, gn, groups)
                record(name, (b, h, w, cin, cout), dtype, err,
                       "int8_check's flip bound", ok=ok, flip_candidates=flips,
                       outputs_differing=int((got != want).sum()))
                check(torch.equal(again, got), f"{name} {x.shape}: two calls differ")
                # each image of a batch equals the same image alone
                both = fn(torch.cat([x[:1], x_other]) if b == 1 else x)
                alone = fn(x[:1].contiguous())
                check(torch.equal(both[:1], alone),
                      f"{name} {x.shape}: batch-variant output")
                if dtype != torch.bfloat16:
                    continue
                # the library's int8 product: torch._int_mm on the im2col'd
                # activations (quantised outside the timing), no prologue,
                # im2col or dequantisation
                xq = torch.clamp(torch.round(x.float() / X_SCALE), -127, 127)
                xq = xq.to(torch.int8).permute(0, 3, 1, 2).float()
                cols = F.unfold(xq, 3, padding=1)  # (B, Cin*9, H*W), c-major
                cols = cols.reshape(b, cin, 9, h * w).permute(0, 3, 2, 1)
                a_mat = cols.reshape(b * h * w, 9 * cin).to(torch.int8).contiguous()
                b_mat = w_q.reshape(cout, 9 * cin).t()  # (K, N) column-major
                flops = 2.0 * b * h * w * 9 * cin * cout
                nbytes = (2.0 * b * h * w * (cin + cout) + 9 * cin * cout
                          + 8.0 * cout + (8.0 * cin if fused else 0.0))
                bf16_w = randn(cout, cin, 3, 3).to(dtype).contiguous(
                    memory_format=torch.channels_last)
                bf16_fn = ((lambda: conv.conv3x3_gn_silu(
                    x, bf16_w, None, gamma, beta, num_groups=groups, eps=1e-5))
                    if fused else (lambda: conv.conv3x3(x, bf16_w, None)))
                iters = 5 if h * w >= 256 * 256 else 20
                timings.setdefault(name, []).append(dict(
                    shape=[b, h, w, cin, cout],
                    ms=graph_ms(fn, iters=iters),
                    stream_ms=cuda_ms(fn, iters=iters),
                    host_ms=host_ms(fn, iters=iters),
                    plain_ms=cuda_ms(ref, iters=iters),
                    library_ms=graph_ms(lambda: torch._int_mm(a_mat, b_mat),
                                        iters=iters),
                    library_scope="torch._int_mm (M = B*H*W, K = 9*Cin, N = "
                                  "Cout) on pre-quantised im2col'd int8 "
                                  "activations: the int8 product alone",
                    bf16_kernel_ms=graph_ms(bf16_fn, iters=iters),
                    bound=bound_ms(flops, nbytes, PEAK_INT8_OPS)))
    log(phase="kernel checks", kernel="conv3x3_int8",
        seconds=time.perf_counter() - t0)

    for name, rows in timings.items():
        for r in rows:
            t, by = r.pop("bound")
            r.update(bound_ms=t, bound_by=by)
            log(timing=name, **r)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default for convs
    return summary, timings


def int8_check(got, want, x, w_q, w_s, bias, fused, gn, groups,
               x_scale: float = X_SCALE):
    """(max |got - want|, whether within the bound, flip candidates).

    The int32 sums are exact on both sides and the epilogue is the same
    IEEE fp32 operations, so the outputs differ only where one activation
    value quantises to another int8 level: where the plain version's
    y * (1 / x_scale) lies within 1e-3 of a rounding boundary (the two
    compute y to a few fp32 ulps of each other). Each such flip moves an
    output by at most |w_q| * w_scale * x_scale of the taps that read it.
    Tolerance, per output: the sum of that over the flip candidates in its
    3x3 x Cin window, plus one rounding step of the output type (2^-7 for
    bf16, 2^-22 for fp32) of |out| + |bias| (a reference may fuse the
    epilogue's multiply and add, rounding once at the product's scale)."""
    from powerpaint_tpu_torch.ops import conv

    F = torch.nn.functional
    if fused:
        y = conv.gn_silu_fp32(x, *gn, num_groups=groups, eps=1e-5)
    else:
        y = x.float()
    v = (y * (1.0 / x_scale)).abs()
    near = ((v - v.floor() - 0.5).abs() < 1e-3) & (v < 128)
    flip = F.conv2d(near.permute(0, 3, 1, 2).double(),
                    w_q.permute(0, 3, 1, 2).abs().double(), padding=1)
    flip = flip.permute(0, 2, 3, 1).float() * (w_s * x_scale)
    step = 2.0 ** (-7 if got.dtype == torch.bfloat16 else -22)
    d = (got.float() - want.float()).abs()
    scale = want.float().abs() + flip
    if bias is not None:
        scale = scale + bias.float().abs()
    tol = flip + step * scale
    return float(d.max()), bool((d <= tol).all()), int(near.sum())


def batch_invariance(device) -> None:
    """Whether each kernel, and the cuBLAS / cuDNN calls of the paths, gives
    an image of a batch the same output as that image in a smaller batch:
    the UNet's CFG batch of a two-request call (4 images) against that of
    one request (the first 2), CLIP's 8 rows against 4, the VAE's 2 images
    against 1, at fp32 (TF32 off) and bf16. Logged, not checked: a
    batch-variant library call is not a fault of the port."""
    from powerpaint_tpu_torch.ops import conv
    from powerpaint_tpu_torch.ops import flash_attention as fa
    from powerpaint_tpu_torch.ops import norms

    F = torch.nn.functional
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(99)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    def nchw_conv(x, wt, pad):
        return F.conv2d(x.permute(0, 3, 1, 2), wt, None, padding=pad)

    cases = []
    for (h, cin, cout) in ((64, 320, 320), (16, 2560, 1280), (8, 1280, 1280)):
        g, bb = 1 + 0.1 * randn(cin), 0.1 * randn(cin)
        wt = randn(cout, cin, 3, 3) / (3 * cin ** 0.5)
        w_q, w_s = conv.quantize_weights_int8(wt)
        cases.append(("conv3x3_gn_silu", (h, h, cin), lambda x, wt=wt, g=g, bb=bb:
                      conv.conv3x3_gn_silu(x, wt.to(x.dtype).contiguous(
                          memory_format=torch.channels_last), None, g, bb,
                          num_groups=32, eps=1e-5)))
        cases.append(("conv3x3_gn_silu_int8", (h, h, cin),
                      lambda x, w_q=w_q, w_s=w_s, g=g, bb=bb:
                      conv.conv3x3_gn_silu_int8(x, w_q, w_s, None, g, bb,
                                                x_scale=X_SCALE, num_groups=32,
                                                eps=1e-5)))
    wt = randn(640, 640, 3, 3) / 80
    cases.append(("conv3x3", (32, 32, 640), lambda x: conv.conv3x3(
        x, wt.to(x.dtype).contiguous(memory_format=torch.channels_last))))
    cases.append(("flash_attention", (4096, 8, 40), lambda x: fa.flash_attention(
        x, x.flip(1).contiguous(), x.roll(1, 1).contiguous())))
    g320, b320 = 1 + 0.1 * randn(320), 0.1 * randn(320)
    cases.append(("group_norm", (4096, 320), lambda x: norms.group_norm(
        x, g320, b320, num_groups=32, eps=1e-6, silu=True)))
    cases.append(("layer_norm", (4096, 320), lambda x: norms.layer_norm(
        x, g320, b320)))
    cases.append(("flash_attention, text context", (4096, 8, 40),
                  lambda x: fa.flash_attention(x, x[:, :77].contiguous(),
                                               x[:, 77:154].contiguous())))
    lw = randn(1280, 320) / 18
    cases.append(("cuBLAS linear", (4096, 320), lambda x: F.linear(x, lw.to(x.dtype))))
    cases.append(("cuBLAS linear, timestep embedding", (320,),
                  lambda x: F.linear(x, lw.to(x.dtype))))
    kw_ = randn(320, 768) / 28
    cases.append(("cuBLAS linear, text context K/V", (77, 768),
                  lambda x: F.linear(x, kw_.to(x.dtype))))
    qw = randn(768, 768) / 28
    # CLIP: 4 rows a prompt (A, B and the two negatives), two prompts vs one
    cases.append(("cuBLAS linear, CLIP", (77, 768),
                  lambda x: F.linear(x, qw.to(x.dtype)), (8, 4)))
    cw = randn(320, 9, 3, 3) / 9
    cases.append(("cuDNN conv_in", (64, 64, 9), lambda x: nchw_conv(
        x, cw.to(x.dtype).contiguous(memory_format=torch.channels_last), 1)))
    sw = randn(320, 640, 1, 1) / 25
    cases.append(("cuDNN 1x1 shortcut", (64, 64, 640), lambda x: nchw_conv(
        x, sw.to(x.dtype).contiguous(memory_format=torch.channels_last), 0)))
    dw = randn(320, 320, 3, 3) / 54
    cases.append(("cuDNN stride-2 downsample", (64, 64, 320), lambda x: F.conv2d(
        x.permute(0, 3, 1, 2), dw.to(x.dtype).contiguous(
            memory_format=torch.channels_last), None, stride=2, padding=1)))
    vw = randn(128, 3, 3, 3) / 5
    # the VAE encodes one image per request
    cases.append(("cuDNN VAE conv_in", (512, 512, 3), lambda x: nchw_conv(
        x, vw.to(x.dtype).contiguous(memory_format=torch.channels_last), 1), (2, 1)))
    for name, shape, fn, *batches in cases:
        big, small = batches[0] if batches else (4, 2)
        for dtype in (torch.float32, torch.bfloat16):
            x = randn(big, *shape).to(dtype)
            many, few = fn(x), fn(x[:small].contiguous())
            d = (many[:small].float() - few.float()).abs()
            log(batch_invariance=name, shape=list(shape),
                dtype=str(dtype).split(".")[-1], batch=[big, small],
                bitwise=bool(torch.equal(many[:small], few)),
                max_abs_diff=float(d.max()),
                max_abs_out=float(few.float().abs().max()))
    torch.backends.cudnn.allow_tf32 = True


# ---------------------------------------------------------------------------
# phases 3 to 6: the main paths
# ---------------------------------------------------------------------------

KERNELS = ("flash_attention", "group_norm", "layer_norm", "conv3x3_gn_silu",
           "conv3x3", "conv3x3_gn_silu_int8", "conv3x3_int8")


def unet_launches(u, with_out_norm: bool = True) -> dict:
    """Launches of one UNet (or BrushNet, which has no conv_norm_out)
    evaluation, CFG in the batch: every transformer runs 2 attentions, 3
    LayerNorms and its GroupNorm; every ResNet unit 2 fused GN+SiLU convs;
    every upsampler one plain conv."""
    n_levels = len(u.block_out_channels)
    n_tf = (sum(k.startswith("CrossAttn") for k in u.down_block_types)
            * u.layers_per_block
            + sum(k.startswith("CrossAttn") for k in u.up_block_types)
            * (u.layers_per_block + 1) + 1) * u.transformer_layers_per_block
    n_res = n_levels * u.layers_per_block + 2 + n_levels * (u.layers_per_block + 1)
    return {"flash_attention": 2 * n_tf, "layer_norm": 3 * n_tf,
            "group_norm": n_tf + int(with_out_norm),
            "conv3x3_gn_silu": 2 * n_res, "conv3x3": n_levels - 1}


def vae_launches(v, decoder: bool) -> dict:
    """One VAE encode or decode: its ResNet units, the mid attention and
    its GroupNorm, the output GroupNorm, the decoder's upsamplers."""
    levels = len(v.block_out_channels)
    n_res = levels * (v.layers_per_block + int(decoder)) + 2
    return {"flash_attention": 1, "layer_norm": 0, "group_norm": 2,
            "conv3x3_gn_silu": 2 * n_res,
            "conv3x3": levels - 1 if decoder else 0}


def _half(n: int) -> int:
    return -(-n // 2)  # the UNet's stride-2 conv with padding 1


def unet_sites(u, h: int, w: int) -> list:
    """(H, W, Cin, Cout) of every GroupNorm-fed conv (conv1 and conv2 of
    each ResNet unit) of one UNet or BrushNet evaluation on an h x w
    latent: the down levels, the mid block, and the up levels, whose units
    take the running feature concatenated with a skip."""
    ch, n, per = u.block_out_channels, len(u.block_out_channels), u.layers_per_block
    sizes = [(h, w)]
    for _ in range(n - 1):
        sizes.append((_half(sizes[-1][0]), _half(sizes[-1][1])))
    sites = []

    def unit(hw, cin, cout):
        sites.extend([(*hw, cin, cout), (*hw, cout, cout)])

    skips, prev = [ch[0]], ch[0]  # conv_in's output is the first skip
    for i in range(n):
        for _ in range(per):
            unit(sizes[i], prev, ch[i])
            prev = ch[i]
            skips.append(ch[i])
        if i < n - 1:
            skips.append(ch[i])  # the downsampler's output
    unit(sizes[-1], ch[-1], ch[-1])
    unit(sizes[-1], ch[-1], ch[-1])
    rev = ch[::-1]
    prev = rev[0]
    for i in range(n):
        for _ in range(per + 1):
            unit(sizes[n - 1 - i], prev + skips.pop(), rev[i])
            prev = rev[i]
    return sites


def vae_sites(v, h: int, w: int, decoder: bool) -> list:
    """The same for one VAE encode (an h x w image) or decode (to one)."""
    ch, n, per = v.block_out_channels, len(v.block_out_channels), v.layers_per_block
    sizes = [(h >> i, w >> i) for i in range(n)]
    sites = []

    def unit(hw, cin, cout):
        sites.extend([(*hw, cin, cout), (*hw, cout, cout)])

    if not decoder:
        prev = ch[0]
        for i in range(n):
            for _ in range(per):
                unit(sizes[i], prev, ch[i])
                prev = ch[i]
    unit(sizes[-1], ch[-1], ch[-1])
    unit(sizes[-1], ch[-1], ch[-1])
    if decoder:
        rev = ch[::-1]
        prev = rev[0]
        for i in range(n):
            for _ in range(per + 1):
                unit(sizes[n - 1 - i], prev, rev[i])
                prev = rev[i]
    return sites


def int8_split(launches: dict, sites: list) -> dict:
    """``launches`` with int8 on: the fused GroupNorm+SiLU convs at the
    sites ``int8_site`` admits move to the int8 kernel."""
    from powerpaint_tpu_torch.ops.conv import int8_site

    check(len(sites) == launches["conv3x3_gn_silu"],
          f"{len(sites)} ResNet sites for {launches['conv3x3_gn_silu']} units")
    n = sum(int8_site(*site) for site in sites)
    return {**launches, "conv3x3_gn_silu": len(sites) - n,
            "conv3x3_gn_silu_int8": n}


def _total(*parts) -> dict:
    """Sum of (count, launches dict) pairs."""
    return {k: sum(n * d.get(k, 0) for n, d in parts) for k in KERNELS}


def _models(cfg, int8_hw, *unets):
    """Per-evaluation launches of each UNet config in ``unets`` (the first
    with ``conv_norm_out``) and of one VAE encode and decode, split by
    ``int8_split`` at an int8_hw x int8_hw image when int8 is on."""
    parts = [unet_launches(u, with_out_norm=i == 0) for i, u in enumerate(unets)]
    parts += [vae_launches(cfg.vae, False), vae_launches(cfg.vae, True)]
    if int8_hw is None:
        return parts
    lat = int8_hw // 8
    sites = [unet_sites(u, lat, lat) for u in unets] + [
        vae_sites(cfg.vae, int8_hw, int8_hw, False),
        vae_sites(cfg.vae, int8_hw, int8_hw, True)]
    return [int8_split(p, s) for p, s in zip(parts, sites)]


def expected_launches(cfg, steps: int, strength: float = 1.0,
                      int8_hw=None) -> dict:
    """Kernel launches one ppt-v1 ``__call__`` implies, from the config: one
    UNet evaluation per kept step, CLIP's 2 LayerNorms a layer and the
    final one, one or two VAE encodes (image latents only at strength < 1)
    and one decode; with int8 on (``int8_hw``, the image's side), the
    ResNet units ``int8_site`` admits on the int8 kernel."""
    t = cfg.text_encoder
    kept = min(int(steps * strength), steps)
    n_enc = 2 if kept < steps else 1
    text = {"layer_norm": 2 * t.num_hidden_layers + 1}
    unet, enc, dec = _models(cfg, int8_hw, cfg.unet)
    return _total((kept, unet), (1, text), (n_enc, enc), (1, dec))


def expected_launches_v2(cfg, steps: int, int8_hw=None) -> dict:
    """One ppt-v2 ``__call__``: per step one BrushNet and one base-UNet
    evaluation (guess mode and gated steps run the branch all the same),
    the two text towers, one VAE encode and one decode."""
    t = cfg.text_encoder
    text = {"layer_norm": 2 * t.num_hidden_layers + 1}
    unet, branch, enc, dec = _models(cfg, int8_hw, cfg.unet, cfg.brushnet.base)
    return _total((steps, unet), (steps, branch), (2, text), (1, enc), (1, dec))


def counters():
    from powerpaint_tpu_torch.ops import conv
    from powerpaint_tpu_torch.ops.flash_attention import flash_attention
    from powerpaint_tpu_torch.ops.norms import group_norm, layer_norm

    return {"flash_attention": flash_attention, "group_norm": group_norm,
            "layer_norm": layer_norm, "conv3x3_gn_silu": conv.conv3x3_gn_silu,
            "conv3x3": conv.conv3x3,
            "conv3x3_gn_silu_int8": conv.conv3x3_gn_silu_int8,
            "conv3x3_int8": conv.conv3x3_int8}


def read_counts() -> dict:
    return {k: f.launches for k, f in counters().items()}


def reset_counts() -> None:
    for f in counters().values():
        f.launches = 0


def instrument(pipe, stage_seconds: dict, finite: list, models=()) -> None:
    """Time the pipeline's four stages and the forward of each named model
    (synchronising around each) and record whether the latents handed to
    the decoder are finite."""
    names = {"_encode_prompts": "text", "_vae_sample": "vae_encode",
             "_denoise": "denoise", "_decode": "decode"}

    def timed(fn, stage):
        def wrapped(*args, **kw):
            if stage == "decode":
                finite.append(bool(torch.isfinite(args[0]).all()))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            stage_seconds[stage] = stage_seconds.get(stage, 0.0) + \
                time.perf_counter() - t0
            return out
        return wrapped

    for attr, stage in names.items():
        setattr(pipe, attr, timed(getattr(pipe, attr), stage))
    for attr, stage in models:
        module = getattr(pipe, attr)
        module.forward = timed(module.forward, stage)


def inputs(hw: int, seed: int):
    rng = np.random.RandomState(seed)
    image = (rng.rand(hw, hw, 3) * 255).astype(np.uint8)
    mask = np.zeros((hw, hw), np.float32)
    mask[hw // 4:3 * hw // 4, hw // 4:3 * hw // 4] = 1.0
    return image, mask


def _tokenizer(cfg):
    from powerpaint_tpu_torch.text.tokenizer import (
        HashTokenizer,
        TokenizerWrapper,
        add_task_tokens,
    )

    tok = TokenizerWrapper(HashTokenizer(cfg.text_encoder.vocab_size))
    add_task_tokens(tok)
    return tok


def _caller(pipe, image, mask, expected, models=()):
    """``call(label, **kw)``: one timed pipeline call that checks its launch
    counts against ``expected(kw)`` and its latents."""
    stage_seconds, finite = {}, []
    instrument(pipe, stage_seconds, finite, models)

    def call(label, **kw):
        kw.setdefault("num_inference_steps", STEPS)
        kw.setdefault("guidance_scale", GUIDANCE)
        before = read_counts()
        stage_seconds.clear()
        finite.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipe(image, mask, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        after = read_counts()
        got = {k: after[k] - before[k] for k in after}
        want = expected(kw)
        log(call=label, seconds=secs, seconds_per_image=secs / out.shape[0],
            stages=dict(stage_seconds), launches=got, shape=list(out.shape),
            dtype=str(out.dtype))
        check(got == want, f"{label}: launches {got}, expected {want}")
        check(finite and all(finite), f"{label}: non-finite latents before decode")
        return out

    return call


def _path_counts(label: str, one_call: dict) -> dict:
    """The launches since the path started; every kernel that one call of
    the path launches (``one_call``, expected counts) must have run, and no
    other."""
    launches = read_counts()  # the path ends here
    log(path=label, path_launches=launches)
    for name, n in launches.items():
        if one_call[name] > 0:
            check(n > 0, f"{name} was not launched on the {label} path")
        else:
            check(n == 0, f"{name} was launched on the {label} path")
    return launches


def run_v1_path(device) -> dict:
    from powerpaint_tpu_torch.core.config import ppt_v1_config
    from powerpaint_tpu_torch.io.weights import init_state
    from powerpaint_tpu_torch.pipelines.inpaint import InpaintPipeline

    cfg = ppt_v1_config()
    t0 = time.perf_counter()
    state = init_state(cfg, torch.Generator(device=device).manual_seed(0),
                       device=device, dtype=torch.bfloat16)
    pipe = InpaintPipeline(cfg, state, _tokenizer(cfg), dtype=torch.bfloat16,
                           device=device)
    del state
    n_params = sum(p.numel() for m in (pipe.unet, pipe.vae, pipe.text_encoder)
                   for p in m.parameters())
    log(phase="setup", path="ppt-v1", params=n_params,
        unet_params=sum(p.numel() for p in pipe.unet.parameters()),
        seconds=time.perf_counter() - t0)

    image, mask = inputs(HW, 0)
    call = _caller(pipe, image, mask, lambda kw: expected_launches(
        cfg, kw["num_inference_steps"], kw.get("strength", 1.0)))

    # warm-up: Triton specialisations and cuDNN / cuBLAS plans for the
    # full-size shapes, so the timed calls below are steady state
    call("v1 warm-up", prompt="a cat", seed=99)

    reset_counts()  # the path starts here
    outs = {}
    for task in TASKS:
        outs[task] = call(f"v1 {task}", prompt="a red bench in a park",
                          task=task, seed=1)
        check(outs[task].shape == (1, HW, HW, 3) and outs[task].dtype == np.uint8,
              f"{task}: output {outs[task].shape} {outs[task].dtype}")
    again = call("v1 text-guided same seed", prompt="a red bench in a park",
                 seed=1)
    check(np.array_equal(again, outs["text-guided"]),
          "v1: the same seed gave a different image")
    other = call("v1 text-guided other seed", prompt="a red bench in a park",
                 seed=2)
    check(not np.array_equal(other, outs["text-guided"]),
          "v1: another seed gave the same image")
    batch = call("v1 batch of two", prompt=["a red bench in a park", "a dog"],
                 negative_prompt=["", "blurry"], fitting_degree=[1.0, 0.5],
                 seed=[1, 5])
    check(batch.shape == (2, HW, HW, 3), f"v1 batch output {batch.shape}")
    d = np.abs(batch[0].astype(np.int32) - outs["text-guided"][0].astype(np.int32))
    log(path="ppt-v1", batch_vs_standalone_max_uint8_diff=int(d.max()),
        batch_vs_standalone_mean_uint8_diff=float(d.mean()))
    call("v1 strength 0.6 eta 0.5", prompt="a red bench in a park", seed=3,
         strength=0.6, eta=0.5)
    launches = _path_counts("ppt-v1", expected_launches(cfg, STEPS))
    profile_call("ppt-v1", lambda: pipe(image, mask, prompt="a red bench in a park",
                                        seed=1, num_inference_steps=STEPS,
                                        guidance_scale=GUIDANCE))
    return launches, outs


def run_v2_path(device) -> dict:
    from powerpaint_tpu_torch.core.config import ppt_v2_config
    from powerpaint_tpu_torch.io.weights import init_state
    from powerpaint_tpu_torch.pipelines.brushnet import BrushNetPipeline

    cfg = ppt_v2_config()
    t0 = time.perf_counter()
    state = init_state(cfg, torch.Generator(device=device).manual_seed(0),
                       device=device, dtype=torch.bfloat16)
    pipe = BrushNetPipeline(cfg, state, _tokenizer(cfg), dtype=torch.bfloat16,
                            device=device)
    del state
    families = ("unet", "brushnet", "vae", "text_encoder",
                "text_encoder_brushnet")
    log(phase="setup", path="ppt-v2",
        params=sum(p.numel() for f in families
                   for p in getattr(pipe, f).parameters()),
        unet_params=sum(p.numel() for p in pipe.unet.parameters()),
        brushnet_params=sum(p.numel() for p in pipe.brushnet.parameters()),
        seconds=time.perf_counter() - t0)

    image, mask = inputs(HW, 0)
    call = _caller(pipe, image, mask,
                   lambda kw: expected_launches_v2(cfg, kw["num_inference_steps"]),
                   models=(("brushnet", "denoise_brushnet"),
                           ("unet", "denoise_base_unet")))
    call("v2 warm-up", prompt="a cat", seed=99)

    reset_counts()  # the path starts here
    prompt = "a red bench in a park"
    outs = {}
    for task in TASKS:
        outs[task] = call(f"v2 {task}", prompt=prompt, task=task, seed=1)
        check(outs[task].shape == (1, HW, HW, 3) and outs[task].dtype == np.uint8,
              f"v2 {task}: output {outs[task].shape} {outs[task].dtype}")
    base = outs["text-guided"]
    again = call("v2 text-guided same seed", prompt=prompt, seed=1)
    check(np.array_equal(again, base), "v2: the same seed gave a different image")
    other = call("v2 text-guided other seed", prompt=prompt, seed=2)
    check(not np.array_equal(other, base), "v2: another seed gave the same image")
    batch = call("v2 batch of two", prompt=[prompt, "a dog"],
                 negative_prompt=["", "blurry"], fitting_degree=[1.0, 0.5],
                 seed=[1, 5])
    check(batch.shape == (2, HW, HW, 3), f"v2 batch output {batch.shape}")
    d = np.abs(batch[0].astype(np.int32) - base[0].astype(np.int32))
    log(path="ppt-v2", batch_vs_standalone_max_uint8_diff=int(d.max()),
        batch_vs_standalone_mean_uint8_diff=float(d.mean()))
    for label, kw in (("v2 conditioning scale 0", dict(brushnet_conditioning_scale=0.0)),
                      ("v2 control_guidance_end 0.5", dict(control_guidance_end=0.5)),
                      ("v2 guess mode", dict(guess_mode=True))):
        out = call(label, prompt=prompt, seed=1, **kw)
        d = np.abs(out.astype(np.int32) - base.astype(np.int32))
        log(call=label, vs_scale_1_max_uint8_diff=int(d.max()),
            vs_scale_1_mean_uint8_diff=float(d.mean()))
        check(d.max() > 0, f"{label}: the image did not change (dead branch)")
    call("v2 45 steps", prompt=prompt, seed=1, num_inference_steps=45)
    launches = _path_counts("ppt-v2", expected_launches_v2(cfg, STEPS))
    profile_call("ppt-v2", lambda: pipe(image, mask, prompt=prompt, seed=1,
                                        num_inference_steps=STEPS,
                                        guidance_scale=GUIDANCE))
    return launches, {"text-guided": base}


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


def saturation_share(pipe, models, run_call) -> dict:
    """One call with forward pre-hooks on every int8 conv of ``models``:
    over the int8 sites of the call's first denoise step (until the base
    UNet's first forward returns), the share of post-SiLU activations (the
    plain prologue's fp32 values) with |y| / x_scale > 127, which the
    static scale clips."""
    from powerpaint_tpu_torch.models.layers import Conv2D
    from powerpaint_tpu_torch.ops.conv import gn_silu_fp32, int8_site

    stats = {"saturated": 0, "values": 0, "sites": 0}
    active = [True]

    def pre(mod, args, kwargs):
        x, gn = args[0], kwargs.get("gn")
        if not active[0] or gn is None or \
                not int8_site(*x.shape[1:], mod.out_channels):
            return
        y = gn_silu_fp32(x.contiguous(), gn.weight, gn.bias,
                         num_groups=gn.num_groups, eps=gn.eps)
        stats["saturated"] += int((y.abs() / mod.int8_x_scale > 127).sum())
        stats["values"] += y.numel()
        stats["sites"] += 1

    handles = [m.register_forward_pre_hook(pre, with_kwargs=True)
               for model in models for m in model.modules()
               if isinstance(m, Conv2D) and m.int8_x_scale is not None]
    handles.append(pipe.unet.register_forward_hook(
        lambda *_: active.__setitem__(0, False)))
    try:
        run_call()
    finally:
        for h in handles:
            h.remove()
    return dict(stats, share=stats["saturated"] / max(stats["values"], 1))


def run_int8_path(device, version: str, refs: dict) -> dict:
    """ppt-v1 (20 DDIM steps: two tasks, the same seed twice, a two-request
    batch) or ppt-v2 (20 UniPC steps: one task and a repeat) with
    POWERPAINT_INT8=1 and the default x_scale, through the pipelines'
    environment option; PSNR against the bf16 path's images ``refs``."""
    import os

    from powerpaint_tpu_torch.core import config
    from powerpaint_tpu_torch.io.weights import init_state
    from powerpaint_tpu_torch.pipelines.brushnet import BrushNetPipeline
    from powerpaint_tpu_torch.pipelines.inpaint import InpaintPipeline

    v1 = version == "ppt-v1"
    cfg = config.ppt_v1_config() if v1 else config.ppt_v2_config()
    label = f"{version} int8"
    os.environ["POWERPAINT_INT8"] = "1"
    os.environ.pop("POWERPAINT_INT8_XSCALE", None)
    t0 = time.perf_counter()
    state = init_state(cfg, torch.Generator(device=device).manual_seed(0),
                       device=device, dtype=torch.bfloat16)
    cls = InpaintPipeline if v1 else BrushNetPipeline
    pipe = cls(cfg, state, _tokenizer(cfg), dtype=torch.bfloat16, device=device)
    del state
    check(pipe.int8_x_scale == 8.0 / 127.0, f"{label}: x_scale {pipe.int8_x_scale}")
    log(phase="setup", path=label, x_scale=pipe.int8_x_scale,
        seconds=time.perf_counter() - t0)

    image, mask = inputs(HW, 0)
    if v1:
        expected = lambda kw: expected_launches(cfg, kw["num_inference_steps"],
                                                int8_hw=HW)
        models = (pipe.unet,)
    else:
        expected = lambda kw: expected_launches_v2(cfg, kw["num_inference_steps"],
                                                   int8_hw=HW)
        models = (pipe.brushnet, pipe.unet)
    call = _caller(pipe, image, mask, expected)
    prompt = "a red bench in a park"
    sat = saturation_share(pipe, models, lambda: call(
        f"{label} warm-up (saturation hooks)", prompt=prompt, seed=1))
    log(path=label, saturation=sat)

    reset_counts()  # the path starts here
    tasks = ("text-guided", "object-removal") if v1 else ("text-guided",)
    outs = {}
    for task in tasks:
        outs[task] = call(f"{label} {task}", prompt=prompt, task=task, seed=1)
        log(path=label, task=task, psnr_vs_bf16=psnr(outs[task], refs[task]))
    again = call(f"{label} text-guided same seed", prompt=prompt, seed=1)
    check(np.array_equal(again, outs["text-guided"]),
          f"{label}: the same seed gave a different image")
    if v1:
        batch = call(f"{label} batch of two", prompt=[prompt, "a dog"],
                     negative_prompt=["", "blurry"], fitting_degree=[1.0, 0.5],
                     seed=[1, 5])
        d = np.abs(batch[0].astype(np.int32) - outs["text-guided"][0].astype(np.int32))
        log(path=label, batch_vs_standalone_max_uint8_diff=int(d.max()),
            batch_vs_standalone_mean_uint8_diff=float(d.mean()))
    launches = _path_counts(label, expected({"num_inference_steps": STEPS}))
    os.environ.pop("POWERPAINT_INT8")
    profile_call(label, lambda: pipe(image, mask, prompt=prompt, seed=1,
                                     num_inference_steps=STEPS,
                                     guidance_scale=GUIDANCE))
    return launches


def run_cli(device) -> dict:
    """``serve.cli.main`` in this process: ppt-v1, POWERPAINT_INT8=1, a
    512x512 PNG and mask written here, 20 steps, full width on the card."""
    import contextlib
    import io
    import os
    import re

    from PIL import Image

    from powerpaint_tpu_torch.core.config import ppt_v1_config
    from powerpaint_tpu_torch.serve import cli

    out_dir = os.path.join("smoke_out", "cli")
    os.makedirs(out_dir, exist_ok=True)
    image, mask = inputs(HW, 3)
    paths = {k: os.path.join(out_dir, f"{k}.png") for k in ("image", "mask", "out")}
    Image.fromarray(image).save(paths["image"])
    Image.fromarray((mask * 255).astype(np.uint8)).save(paths["mask"])
    argv = ["--image", paths["image"], "--mask", paths["mask"], "--output",
            paths["out"], "--prompt", "a red bench in a park", "--steps",
            str(STEPS), "--short_side", str(HW), "--seed", "1"]
    os.environ["POWERPAINT_INT8"] = "1"
    reset_counts()  # the path starts here
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        rc = cli.main(argv)
    secs = time.perf_counter() - t0
    want = expected_launches(ppt_v1_config(), STEPS, int8_hw=HW)
    launches = _path_counts("cli ppt-v1 int8", want)
    os.environ.pop("POWERPAINT_INT8")
    line = printed.getvalue().strip()
    log(path="cli", argv=argv, rc=rc, printed=line, seconds=secs,
        launches=launches)
    check(rc == 0, f"cli: exit code {rc}")
    check(launches == want, f"cli: launches {launches}, expected {want}")
    check(re.fullmatch(rf"wrote {re.escape(paths['out'])} \({HW}x{HW}\) in "
                       rf"[0-9.]+s \({STEPS} steps\)", line) is not None,
          f"cli: output line {line!r}")
    with Image.open(paths["out"]) as im:
        check(im.size == (HW, HW) and im.mode == "RGB",
              f"cli: wrote {im.size} {im.mode}")
    return launches


def profile_call(label: str, run_call) -> None:
    """One 20-step call under ``torch.profiler``: device time by kernel
    family and the top kernels, and the device's busy share of the call's
    wall time, against the profiled call and against the same call
    unprofiled (the profiler slows the host side)."""
    from torch.profiler import ProfilerActivity, profile

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_call()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e6

    plain_wall_us = run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_us = run()
    kernels = [(e.key, e.self_device_time_total, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_us = sum(t for _, t, _ in kernels)
    if not kernels:
        log(profile=label, result="not measured: the profiler recorded no device time")
        return
    kernels.sort(key=lambda k: -k[1])
    # device time by family, from the kernel names (first match wins); the
    # GroupNorm family holds the statistics launches of the fused conv too
    families = (("flash_attention", ("flash_",)),
                ("conv3x3 kernel", ("conv3x3_kernel",)),
                ("conv3x3 int8 kernel", ("conv3x3_int8_kernel",)),
                ("group_norm", ("_gn_",)), ("layer_norm", ("_ln_kernel",)),
                ("cudnn conv", ("fprop", "conv")),
                ("matmul", ("gemm", "nvjet", "cutlass")))
    by_family = {}
    for name, t, _ in kernels:
        fam = next((f for f, keys in families if any(k in name for k in keys)),
                   "other")
        by_family[fam] = by_family.get(fam, 0.0) + t / 1e3
    log(profile=label, steps=STEPS, device_ms_by_family=by_family,
        wall_ms=wall_us / 1e3, unprofiled_wall_ms=plain_wall_us / 1e3,
        device_busy_ms=busy_us / 1e3, device_busy_share=busy_us / wall_us,
        device_busy_share_unprofiled=busy_us / plain_wall_us,
        top_kernels=[dict(name=n[:90], ms=t / 1e3, calls=c, share=t / busy_us)
                     for n, t, c in kernels[:12]])


def tiny_reference(device) -> None:
    """The tiny ppt-v1 and ppt-v2 configurations, fp32, through the kernels
    on the card and through the plain versions on the CPU, with the same
    weights and the same noise: the uint8 images must agree within the JAX
    package's end-to-end bound (max 3, mean 0.5).

    ppt-v1 with int8 on (every ResNet unit is an int8 site at this size) is
    held site by site instead: static-scale quantisation turns an fp32 ulp
    of difference anywhere upstream into a whole int8 level wherever a value
    sits at a rounding boundary, and the flips compound over the layers, so
    two right implementations need not give close images. Each int8 unit of
    the card's call is recomputed by the plain version on the CPU from the
    input the card gave it, within ``int8_check``'s flip bound; the images'
    difference is logged."""
    from powerpaint_tpu_torch.models.layers import Conv2D
    from powerpaint_tpu_torch.ops import conv
    from powerpaint_tpu_torch.io.weights import init_state
    from powerpaint_tpu_torch.pipelines.brushnet import (
        BrushNetPipeline,
        cond_scale_table,
    )
    from powerpaint_tpu_torch.pipelines.inpaint import InpaintPipeline
    from powerpaint_tpu_torch.testing import tiny_v1_config, tiny_v2_config
    from powerpaint_tpu_torch.text.prompts import add_task, v2_prompt_suffix
    from powerpaint_tpu_torch.text.tokenizer import (
        HashTokenizer,
        TokenizerWrapper,
        add_task_tokens,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tok = TokenizerWrapper(HashTokenizer(994))
    add_task_tokens(tok)
    image, mask = inputs(64, 1)
    mask_u8 = (mask >= 0.5).astype(np.uint8)[None, ..., None] * 255

    def v1(pipe, dev, noise):
        ids = pipe.encode_task(add_task("a dog", "", "text-guided"))[None]
        return pipe._generate(
            torch.as_tensor(ids, dtype=torch.long, device=dev),
            torch.tensor([0.6], device=dev), torch.as_tensor(image[None], device=dev),
            torch.as_tensor(mask_u8, device=dev), torch.tensor([7.5], device=dev),
            *noise, None, num_steps=3, strength_steps=3, output_type="uint8")

    def v2(pipe, dev, noise):
        task = "object-removal"
        ids_t, ids_u = pipe.encode_task(
            add_task(v2_prompt_suffix("a dog", task), "", task, "ppt-v2"))
        return pipe._generate(
            torch.as_tensor(ids_t[None], dtype=torch.long, device=dev),
            torch.as_tensor(ids_u[None], dtype=torch.long, device=dev),
            torch.tensor([0.6], device=dev), torch.as_tensor(image[None], device=dev),
            torch.as_tensor(mask_u8, device=dev), torch.tensor([7.5], device=dev),
            cond_scale_table(3, 1.0, 0.0, 1.0), *noise[:2], num_steps=3,
            output_type="uint8")

    for label, cfg, cls, gen, int8 in (
            ("ppt-v1", tiny_v1_config(), InpaintPipeline, v1, False),
            ("ppt-v2", tiny_v2_config(), BrushNetPipeline, v2, False),
            ("ppt-v1 int8", tiny_v1_config(), InpaintPipeline, v1, True)):
        state = init_state(cfg, torch.Generator().manual_seed(0), device="cpu",
                           dtype=torch.float32)
        outs, sites = {}, []
        for dev in ("cpu", device):
            pipe = cls(cfg, state, tok, dtype=torch.float32, device=dev,
                       int8=int8)
            if int8 and dev != "cpu":
                for m in list(pipe.unet.modules()) + list(pipe.vae.modules()):
                    if isinstance(m, Conv2D) and m.int8_x_scale is not None:
                        m.register_forward_hook(
                            lambda mod, args, kw, out: sites.append(
                                (mod, args[0].cpu(), kw["gn"], out.cpu())),
                            with_kwargs=True)
            g = torch.Generator().manual_seed(7)
            noise = [torch.randn((1, 8, 8, 4), generator=g).to(dev) for _ in range(3)]
            outs[dev] = gen(pipe, dev, noise).cpu().numpy().astype(np.int32)
        d = np.abs(outs["cpu"] - outs[device])
        log(tiny_reference=label, max_uint8_diff=int(d.max()),
            mean_uint8_diff=float(d.mean()))
        if not int8:
            check(d.max() <= 3 and d.mean() <= 0.5,
                  f"tiny {label}: card vs CPU uint8 diff max {d.max()} mean {d.mean()}")
            continue
        worst, flips = 0.0, 0
        for m, x, gn, out in sites:
            cpu = lambda t: t.detach().cpu()
            args = (cpu(m.w_q), cpu(m.w_scale), cpu(m.bias_fp32))
            gb = (cpu(gn.weight), cpu(gn.bias))
            want = conv.conv3x3_gn_silu_int8_plain(
                x, *args, *gb, x_scale=m.int8_x_scale,
                num_groups=gn.num_groups, eps=gn.eps)
            err, ok, n = int8_check(out, want, x, args[0], args[1], args[2],
                                    True, gb, gn.num_groups, m.int8_x_scale)
            check(ok, f"tiny {label}: an int8 unit {tuple(x.shape)} is {err} "
                      "from the plain version on the CPU, beyond the flip bound")
            worst, flips = max(worst, err), flips + n
        n_units = (3 * len(unet_sites(cfg.unet, 8, 8))
                   + len(vae_sites(cfg.vae, 64, 64, False))
                   + len(vae_sites(cfg.vae, 64, 64, True)))
        check(len(sites) == n_units,
              f"tiny {label}: {len(sites)} int8 units ran, not {n_units}")
        log(tiny_reference=label, int8_units=len(sites), max_abs_err=worst,
            flip_candidates=flips)
    torch.backends.cudnn.allow_tf32 = True


META = {
    "flash_attention": dict(
        route="cuda", source="powerpaint_tpu_torch/csrc/flash_attention.cu",
        replaces="powerpaint_tpu/ops/flash_attention.py:28"),
    "group_norm": dict(
        route="triton", source="powerpaint_tpu_torch/ops/norms.py",
        replaces="powerpaint_tpu/ops/norms_pallas.py:78"),
    "layer_norm": dict(
        route="triton", source="powerpaint_tpu_torch/ops/norms.py",
        replaces="powerpaint_tpu/ops/norms_pallas.py:27"),
    "conv3x3_gn_silu": dict(
        route="cuda", source="powerpaint_tpu_torch/csrc/conv3x3.cu",
        replaces="powerpaint_tpu/ops/conv_pallas.py:106"),
    "conv3x3": dict(
        route="cuda", source="powerpaint_tpu_torch/csrc/conv3x3.cu",
        replaces="powerpaint_tpu/ops/conv_pallas.py:91"),
    "conv3x3_gn_silu_int8": dict(
        route="cuda", source="powerpaint_tpu_torch/csrc/conv3x3_int8.cu",
        replaces="powerpaint_tpu/ops/conv_pallas.py:295"),
    "conv3x3_int8": dict(
        route="cuda", source="powerpaint_tpu_torch/csrc/conv3x3_int8.cu",
        replaces="powerpaint_tpu/ops/conv_pallas.py:272"),
}


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no GPU, no result")
    try:
        from powerpaint_tpu_torch.ops import _build
    except ImportError as e:
        fail(f"the powerpaint_tpu_torch package is not beside this script ({e})")
    device = torch.device("cuda", 0)

    # phase 1: the card and the build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    import triton

    log(torch=torch.__version__, cuda=torch.version.cuda,
        triton=triton.__version__, device=torch.cuda.get_device_name(0),
        capability=list(torch.cuda.get_device_capability(0)))
    t0 = time.perf_counter()
    nvcc_logs = _build.build(_build.SOURCES)
    for name, text in nvcc_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(nvcc=name, ptxas=line.strip())
    log(phase="build", sources=list(_build.SOURCES),
        seconds=time.perf_counter() - t0)

    # phase 2: kernels against their plain versions, and their times
    t0 = time.perf_counter()
    summary, timings = check_kernels(device)
    log(phase="kernel checks", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    batch_invariance(device)
    log(phase="batch invariance", seconds=time.perf_counter() - t0)

    # phases 3 to 6: the main paths, then the small references
    launches = {k: 0 for k in KERNELS}
    refs = {}
    paths = (("ppt-v1", run_v1_path), ("ppt-v2", run_v2_path),
             ("ppt-v1 int8", lambda d: run_int8_path(d, "ppt-v1", refs["ppt-v1"])),
             ("ppt-v2 int8", lambda d: run_int8_path(d, "ppt-v2", refs["ppt-v2"])),
             ("cli", run_cli))
    for label, run in paths:
        t0 = time.perf_counter()
        counts = run(device)
        if isinstance(counts, tuple):
            counts, refs[label] = counts
        for k, n in counts.items():
            launches[k] += n
        torch.cuda.empty_cache()
        log(phase="main path", path=label, seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    tiny_reference(device)
    log(phase="tiny reference", seconds=time.perf_counter() - t0)

    kernels = []
    for name, m in META.items():
        head = timings[name][0]  # the main paths' most launched shape
        kernels.append(dict(
            name=name, **m, launches=launches[name],
            max_abs_err=summary[name]["max_abs_err"],
            ms=head["ms"], stream_ms=head["stream_ms"], host_ms=head["host_ms"],
            plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"], shape=head["shape"],
            checks=summary[name]["checks"],
            **{k: head[k] for k in ("library_scope", "bf16_kernel_ms")
               if k in head}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
