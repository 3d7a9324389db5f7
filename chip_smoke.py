#!/usr/bin/env python3
"""Drive the PyTorch port (``powerpaint_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. The card (``nvidia-smi`` name and power limit), the torch / CUDA / Triton
   versions, then the build of the CUDA sources in
   ``powerpaint_tpu_torch/csrc`` with its time.
2. Kernel checks: each kernel of the main path (flash attention in CUDA,
   GroupNorm(+SiLU) and LayerNorm in Triton) against its plain PyTorch
   version at the main path's shapes, in fp32 (TF32 off for matmuls and
   convs) and in bf16, and timed beside the plain version, one PyTorch
   library call of the same function, and the data-sheet bound.
3. The main path: full-width ppt-v1 (860M-parameter 9-channel UNet, SD1.5
   VAE, CLIP ViT-L/14 text with 30 task-token rows), random weights from a
   seed, bf16, a 512x512 image: the four tasks at 20 DDIM steps with
   guidance 7.5, the same seed twice, another seed, a two-request batch and
   one call with strength 0.6 and eta 0.5. Each call must launch every
   kernel the number of times its shapes imply, the latents before decode
   must be finite, and a tiny configuration must give the same image
   through the kernels as through the plain versions on the CPU.
4. The ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

With no GPU the script fails before printing any result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# Data-sheet peaks of an H100 SXM at its 700 W limit (NVIDIA): dense bf16
# tensor-core rate and HBM3 bandwidth. Bounds below are arithmetic on
# these, not measurements.
PEAK_BF16_FLOPS = 989e12
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
    """Mean device time of one call, from CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls. Where the host enqueues a
    call more slowly than the card runs it, this is the host's pace."""
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


def bound_ms(flops: float, nbytes: float):
    """Least time on the card for the work: the larger of bytes over the
    memory rate and operations over the bf16 tensor-core rate."""
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
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
    from powerpaint_tpu_torch.ops import flash_attention as fa
    from powerpaint_tpu_torch.ops import norms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(1234)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    summary = {}

    def record(name, shape, dtype, err, tol):
        log(check=name, shape=list(shape), dtype=str(dtype).split(".")[-1],
            max_abs_err=err, tol=tol)
        check(err <= tol, f"{name} {shape} {dtype}: max |err| {err} > {tol}")
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
                ms=cuda_ms(lambda: fa.flash_attention(q, k, v)),
                host_ms=host_ms(lambda: fa.flash_attention(q, k, v)),
                plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v),
                                 iters=5),
                library_ms=cuda_ms(
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
                ms=cuda_ms(lambda: norms.group_norm(x, w, bb, **kw)),
                host_ms=host_ms(lambda: norms.group_norm(x, w, bb, **kw)),
                plain_ms=cuda_ms(lambda: norms.group_norm_plain(x, w, bb, **kw)),
                library_ms=cuda_ms(library),
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
                ms=cuda_ms(lambda: norms.layer_norm(x, w, bb, eps=eps)),
                host_ms=host_ms(lambda: norms.layer_norm(x, w, bb, eps=eps)),
                plain_ms=cuda_ms(lambda: norms.layer_norm_plain(x, w, bb, eps=eps)),
                library_ms=cuda_ms(lambda: torch.nn.functional.layer_norm(
                    x, (c,), wl, bl, eps)),
                bound=bound_ms(0.0, nbytes)))
    log(phase="kernel checks", kernel="layer_norm",
        seconds=time.perf_counter() - t0)

    for name, rows in timings.items():
        for r in rows:
            t, by = r.pop("bound")
            r.update(bound_ms=t, bound_by=by)
            log(timing=name, **r)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default for convs
    return summary, timings


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------


def expected_launches(cfg, steps: int, strength: float = 1.0) -> dict:
    """Kernel launches one ``__call__`` implies, counted from the config:
    per UNet evaluation (one per step, CFG in the batch) every transformer
    runs 2 attentions and 3 LayerNorms and adds its GroupNorm to the two of
    every ResNet; CLIP runs 2 LayerNorms a layer plus the final one; each
    VAE pass runs its ResNets' norms, the mid attention and its norm, and
    the output norm."""
    u, v, t = cfg.unet, cfg.vae, cfg.text_encoder
    n_levels = len(u.block_out_channels)
    n_tf = (sum(k.startswith("CrossAttn") for k in u.down_block_types)
            * u.layers_per_block
            + sum(k.startswith("CrossAttn") for k in u.up_block_types)
            * (u.layers_per_block + 1) + 1) * u.transformer_layers_per_block
    n_res = n_levels * u.layers_per_block + 2 + n_levels * (u.layers_per_block + 1)
    unet = dict(attn=2 * n_tf, ln=3 * n_tf, gn=2 * n_res + n_tf + 1)
    v_levels = len(v.block_out_channels)
    enc_gn = 2 * v_levels * v.layers_per_block + 5 + 1
    dec_gn = 2 * v_levels * (v.layers_per_block + 1) + 5 + 1
    kept = min(int(steps * strength), steps)
    n_enc = 2 if kept < steps else 1  # image latents only when strength < 1
    return {
        "flash_attention": kept * unet["attn"] + n_enc + 1,
        "layer_norm": kept * unet["ln"] + 2 * t.num_hidden_layers + 1,
        "group_norm": kept * unet["gn"] + n_enc * enc_gn + dec_gn,
    }


def counters():
    from powerpaint_tpu_torch.ops.flash_attention import flash_attention
    from powerpaint_tpu_torch.ops.norms import group_norm, layer_norm

    return {"flash_attention": flash_attention, "group_norm": group_norm,
            "layer_norm": layer_norm}


def read_counts() -> dict:
    return {k: f.launches for k, f in counters().items()}


def reset_counts() -> None:
    for f in counters().values():
        f.launches = 0


def instrument(pipe, stage_seconds: dict, finite: list) -> None:
    """Time the pipeline's four stages (synchronising around each) and
    record whether the latents handed to the decoder are finite."""
    names = {"_encode_prompts": "text", "_vae_sample": "vae_encode",
             "_denoise": "denoise", "_decode": "decode"}
    for attr, stage in names.items():
        fn = getattr(pipe, attr)

        def wrapped(*args, _fn=fn, _stage=stage, **kw):
            if _stage == "decode":
                finite.append(bool(torch.isfinite(args[0]).all()))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*args, **kw)
            torch.cuda.synchronize()
            stage_seconds[_stage] = stage_seconds.get(_stage, 0.0) + \
                time.perf_counter() - t0
            return out

        setattr(pipe, attr, wrapped)


def inputs(hw: int, seed: int):
    rng = np.random.RandomState(seed)
    image = (rng.rand(hw, hw, 3) * 255).astype(np.uint8)
    mask = np.zeros((hw, hw), np.float32)
    mask[hw // 4:3 * hw // 4, hw // 4:3 * hw // 4] = 1.0
    return image, mask


def run_main_path(device) -> dict:
    from powerpaint_tpu_torch.core.config import ppt_v1_config
    from powerpaint_tpu_torch.io.weights import init_state
    from powerpaint_tpu_torch.pipelines.inpaint import InpaintPipeline
    from powerpaint_tpu_torch.text.tokenizer import (
        HashTokenizer,
        TokenizerWrapper,
        add_task_tokens,
    )

    cfg = ppt_v1_config()
    t0 = time.perf_counter()
    state = init_state(cfg, torch.Generator(device=device).manual_seed(0),
                       device=device, dtype=torch.bfloat16)
    tok = TokenizerWrapper(HashTokenizer(cfg.text_encoder.vocab_size))
    add_task_tokens(tok)
    pipe = InpaintPipeline(cfg, state, tok, dtype=torch.bfloat16, device=device)
    del state
    n_params = sum(p.numel() for m in (pipe.unet, pipe.vae, pipe.text_encoder)
                   for p in m.parameters())
    log(phase="setup", params=n_params,
        unet_params=sum(p.numel() for p in pipe.unet.parameters()),
        seconds=time.perf_counter() - t0)

    image, mask = inputs(HW, 0)
    stage_seconds, finite = {}, []
    instrument(pipe, stage_seconds, finite)

    def call(label, **kw):
        before = read_counts()
        stage_seconds.clear()
        finite.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipe(image, mask, num_inference_steps=STEPS,
                   guidance_scale=GUIDANCE, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        after = read_counts()
        got = {k: after[k] - before[k] for k in after}
        batch = out.shape[0]
        want = expected_launches(cfg, STEPS, kw.get("strength", 1.0))
        log(call=label, seconds=secs, seconds_per_image=secs / batch,
            stages=dict(stage_seconds), launches=got, shape=list(out.shape),
            dtype=str(out.dtype))
        check(got == want, f"{label}: launches {got}, expected {want}")
        check(finite and all(finite), f"{label}: non-finite latents before decode")
        return out

    # warm-up: Triton specialisations and cuDNN / cuBLAS plans for the
    # full-size shapes, so the timed calls below are steady state
    call("warm-up", prompt="a cat", seed=99)

    reset_counts()  # the main path starts here
    outs = {}
    for task in TASKS:
        outs[task] = call(task, prompt="a red bench in a park", task=task,
                          seed=1)
        check(outs[task].shape == (1, HW, HW, 3) and outs[task].dtype == np.uint8,
              f"{task}: output {outs[task].shape} {outs[task].dtype}")
    again = call("text-guided same seed", prompt="a red bench in a park",
                 seed=1)
    check(np.array_equal(again, outs["text-guided"]),
          "the same seed gave a different image")
    other = call("text-guided other seed", prompt="a red bench in a park",
                 seed=2)
    check(not np.array_equal(other, outs["text-guided"]),
          "another seed gave the same image")
    batch = call("batch of two", prompt=["a red bench in a park", "a dog"],
                 negative_prompt=["", "blurry"], fitting_degree=[1.0, 0.5],
                 seed=[1, 5])
    check(batch.shape == (2, HW, HW, 3), f"batch output {batch.shape}")
    d = np.abs(batch[0].astype(np.int32) - outs["text-guided"][0].astype(np.int32))
    log(batch_vs_standalone_max_uint8_diff=int(d.max()),
        batch_vs_standalone_mean_uint8_diff=float(d.mean()))
    call("strength 0.6 eta 0.5", prompt="a red bench in a park", seed=3,
         strength=0.6, eta=0.5)
    launches = read_counts()  # the main path ends here
    log(main_path_launches=launches)
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")
    profile_call(pipe, image, mask)
    return launches


def profile_call(pipe, image, mask) -> None:
    """One text-guided call under ``torch.profiler``: device time by kernel
    (the top ones) and the device's busy share of the call's wall time,
    against the profiled call and against the same call unprofiled (the
    profiler slows the host side)."""
    from torch.profiler import ProfilerActivity, profile

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe(image, mask, prompt="a red bench in a park", seed=1,
             num_inference_steps=STEPS, guidance_scale=GUIDANCE)
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
        log(profile="not measured: the profiler recorded no device time")
        return
    kernels.sort(key=lambda k: -k[1])
    # device time by family, from the kernel names (first match wins)
    families = (("flash_attention", ("flash_",)), ("group_norm", ("_gn_",)),
                ("layer_norm", ("_ln_kernel",)), ("conv", ("fprop", "conv")),
                ("matmul", ("gemm", "nvjet", "cutlass")))
    by_family = {}
    for name, t, _ in kernels:
        fam = next((f for f, keys in families if any(k in name for k in keys)),
                   "other")
        by_family[fam] = by_family.get(fam, 0.0) + t / 1e3
    log(profile="one 20-step call", device_ms_by_family=by_family, wall_ms=wall_us / 1e3,
        unprofiled_wall_ms=plain_wall_us / 1e3, device_busy_ms=busy_us / 1e3,
        device_busy_share=busy_us / wall_us,
        device_busy_share_unprofiled=busy_us / plain_wall_us,
        top_kernels=[dict(name=n[:90], ms=t / 1e3, calls=c, share=t / busy_us)
                     for n, t, c in kernels[:12]])


def tiny_reference(device) -> None:
    """The tiny ppt-v1 configuration, fp32, through the kernels on the card
    and through the plain versions on the CPU, with the same weights and
    the same noise: the uint8 images must agree within the JAX package's
    end-to-end bound (max 3, mean 0.5)."""
    from powerpaint_tpu_torch.io.weights import init_state
    from powerpaint_tpu_torch.pipelines.inpaint import InpaintPipeline
    from powerpaint_tpu_torch.testing import tiny_v1_config
    from powerpaint_tpu_torch.text.prompts import add_task
    from powerpaint_tpu_torch.text.tokenizer import (
        HashTokenizer,
        TokenizerWrapper,
        add_task_tokens,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = tiny_v1_config()
    state = init_state(cfg, torch.Generator().manual_seed(0), device="cpu",
                       dtype=torch.float32)
    tok = TokenizerWrapper(HashTokenizer(994))
    add_task_tokens(tok)
    image, mask = inputs(64, 1)
    outs = {}
    for dev in ("cpu", device):
        pipe = InpaintPipeline(cfg, state, tok, dtype=torch.float32, device=dev)
        g = torch.Generator().manual_seed(7)
        noise = [torch.randn((1, 8, 8, 4), generator=g).to(dev) for _ in range(3)]
        ids = pipe.encode_task(add_task("a dog", "", "text-guided"))[None]
        out = pipe._generate(
            torch.as_tensor(ids, dtype=torch.long, device=dev),
            torch.tensor([0.6], device=dev),
            torch.as_tensor(image[None], device=dev),
            torch.as_tensor((mask >= 0.5).astype(np.uint8)[None, ..., None] * 255,
                            device=dev),
            torch.tensor([7.5], device=dev), *noise, None,
            num_steps=3, strength_steps=3, output_type="uint8")
        outs[dev] = out.cpu().numpy().astype(np.int32)
    d = np.abs(outs["cpu"] - outs[device])
    log(tiny_reference_max_uint8_diff=int(d.max()),
        tiny_reference_mean_uint8_diff=float(d.mean()))
    check(d.max() <= 3 and d.mean() <= 0.5,
          f"tiny config: card vs CPU uint8 diff max {d.max()} mean {d.mean()}")
    torch.backends.cudnn.allow_tf32 = True


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

    # phase 3: the main path, then a small reference
    t0 = time.perf_counter()
    launches = run_main_path(device)
    log(phase="main path", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    tiny_reference(device)
    log(phase="tiny reference", seconds=time.perf_counter() - t0)

    meta = {
        "flash_attention": dict(
            route="cuda", source="powerpaint_tpu_torch/csrc/flash_attention.cu",
            replaces="powerpaint_tpu/ops/flash_attention.py:28"),
        "group_norm": dict(
            route="triton", source="powerpaint_tpu_torch/ops/norms.py",
            replaces="powerpaint_tpu/ops/norms_pallas.py:78"),
        "layer_norm": dict(
            route="triton", source="powerpaint_tpu_torch/ops/norms.py",
            replaces="powerpaint_tpu/ops/norms_pallas.py:27"),
    }
    kernels = []
    for name, m in meta.items():
        head = timings[name][0]  # the main path's most launched shape
        kernels.append(dict(
            name=name, **m, launches=launches[name],
            max_abs_err=summary[name]["max_abs_err"],
            ms=head["ms"], kernel_ms=head["ms"], host_ms=head["host_ms"],
            plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"], shape=head["shape"],
            checks=summary[name]["checks"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
