#!/usr/bin/env python3
"""Drive the PyTorch port (``powerpaint_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. The card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, then the build of the CUDA sources in
   ``powerpaint_tpu_torch/csrc`` (one nvcc each, started together) with its
   time, each kernel's registers, spills and ptxas performance warnings,
   GroupNorm's and LayerNorm's cuts at the checked shapes, and the count
   of wgmma instructions (HGMMA, IGMMA) in its SASS.
2. Kernel checks: each kernel of the main paths (flash attention, the 3x3
   conv with and without its GroupNorm+SiLU prologue, the static-scale
   int8 conv, and GroupNorm in its four modes (statistics, apply, the
   int8 units' GroupNorm+SiLU+quantise, and the quantiser of x alone), and
   LayerNorm, all in CUDA) against its plain PyTorch version at the
   main paths' shapes (LayerNorm also at a ragged C on misaligned rows;
   GroupNorm at every BiT shape of the DPT forward and LayerNorm at the
   safety checker's rows, in fp32, the annotator path's type; every kernel
   also at a 768 x 512 image's shapes, where H != W; the modes sequence
   parallelism adds at a rank's half of a 1024^2 canvas: the flash
   kernel's log-sum-exp mode (its fp32 output to 2^-14 (fp32) or 2^-7
   (bf16) of its largest value and of its 2-norm, the
   log-sum-exp to 1e-5 (fp32) or 1e-3 (bf16) relative, beside ATen's flash
   or memory-efficient op, which return one too), GroupNorm's moments
   mode (mean and M2, to 1e-5 of the plain two-pass moments, beside
   ``torch.var_mean``) and its apply and quantise modes from given
   statistics (the apply to B3's bound, the quantiser bitwise)), and the
   flash kernel's bf16-softmax mode (``scripts/torch_perf_attn_bf16.py``'s
   experiment) against its plain version at the kernel's block of keys
   to ``BSM_RTOL`` of the output's largest value and of its 2-norm, with
   B1's output on the same inputs as the control that must miss it (the
   mode is timed by phase 7k), in fp32 (TF32 off for matmuls and convs) and in bf16, and timed beside
   the plain version, one PyTorch library call of the same function (or
   the chain of calls named), and the data-sheet bound. The int8 units and the quantising modes must be bitwise equal to
   their plain versions, and the statistics bitwise equal across the
   modes. A kernel's ``ms`` and the library call's are device
   time (a CUDA graph of 20 calls replayed), ``stream_ms`` the same calls
   enqueued one by one (the host's pace where it is the slower),
   ``host_ms`` the host's enqueue alone; attention adds the exp2 floor
   (one MUFU.EX2 per score), the convs their Cout tile and K split,
   GroupNorm its form and cluster, LayerNorm its cut of a row, the fused
   convs ``unfused_ms`` (the GroupNorm kernel's apply mode, then the plain
   bf16 conv), the int8 units the time of their two launches apart. Then
   each kernel's batch invariance: a CFG batch of two requests (4 images)
   against one request (2 images), and the same for the cuBLAS and cuDNN
   calls the paths make; the bf16 flash attention and conv kernels must be
   bitwise invariant and deterministic, and so must GroupNorm, LayerNorm
   and the int8 unit. Then the gradients (``grad_checks``): each
   differentiable wrapper (flash attention, the fused and the plain conv,
   GroupNorm, LayerNorm) at the shapes a full-width v1 train step gives it,
   in bf16: its output carries its ``torch.autograd.Function``'s
   ``grad_fn``, its forward is the kernel's, and its gradients (a
   recompute of the plain version) equal autograd of the plain version
   within one bf16 step of each input's largest gradient.
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
   step. Each ResNet unit's launches are counted by its quantiser or its
   statistics launch too, exactly.
6. The command line, ``serve.cli.main`` in this process: ppt-v1 with int8
   on, a 512x512 PNG and mask written by the script, 20 steps, its launch
   counts, the PNG it writes and its output line.
7. The ppt-v1 + ControlNet path: full width (the ppt-v1 stack and an SD1.5
   ControlNet branch: the UNet's down and mid half on the 4-channel
   latent, the conditioning embedding, 13 zero convs), random bf16
   weights from a seed, 512x512 with a drawn edge map, 20 DDIM steps,
   guidance 7.5: the four tasks, the same seed twice, another seed, no
   control image (which must equal the ppt-v1 path's image bit for bit:
   the v1 families draw the same weights), guess mode,
   control_guidance_end 0.5, two branches, a two-request batch, and one
   call with int8 on (PSNR against the bf16 image of the same seed, the
   saturated share). Each call's launches are the config's, exactly;
   stage times keep the branch and the base UNet apart; one profiled call.
   7b. The control maps, the annotators and the safety checker: full
   published width, random fp32 weights from seeds, at PyTorch's default
   precision (cuDNN convolutions in TF32, matmuls in fp32), no OpenCV.
   DPT-hybrid depth (384^2 in, 1024^2 out; 52 GroupNorm kernel launches a
   map, exact), HED (512^2, its bucket's size), canny (host maps at 512^2
   and 1024^2; 512^2 and 512 x 600), HED at 512 x 600 (resized to its
   512 x 576 bucket and back on the card) plain and scribble, and pose
   (``OpenposeBodyPreprocessor``: its resizes on the card, the decode and
   drawing on the host), each through ``PowerPaint.infer(control_type=
   ...)`` on the ppt-v1 + ControlNet stack at 20 DDIM steps; the CLIP
   ViT-L/14 safety checker (50 LayerNorm kernel launches a check, exact)
   registered for a ppt-v1 call, then one whose thresholds are -1, which
   must flag the image and black it out. Each window's launches are exact.
   Then HED's and pose's map steps on the card against the same functions
   on the CPU, bitwise, and each of the four networks on the card against
   the CPU at a reduced input: within 1e-3 of the CPU output's largest
   magnitude with TF32 off, within 0.1 at the default precision.
   7c. The sampler family (``run_sampler_path``), full width, bf16, 512^2:
   ppt-v1 with each registry sampler but DDIM at 5 steps (20 before
   phase 7i; LCM at 4),
   euler at strength 0.6, euler_a repeated (bitwise) and as a two-request
   batch (each image's step noise bitwise its standalone draw, the images
   within Queue C's batch-vs-alone difference); ppt-v2 with euler_a, and
   an LCM-distilled UNet (``time_cond_proj_dim`` 256) at 4 LCM steps whose
   guidance 5 and 9 differ; ppt-v1 + ControlNet with heun (39
   evaluations) and a window. Launches exact at the sampler's evaluation
   count; seconds per image and the denoise loop's device ms per UNet
   evaluation for each sampler.
   7d. Checkpoints, LoRA and textual inversion (``run_checkpoint_path``),
   full width, in ``smoke_out/checkpoints`` (free disk logged and checked
   first, each layout removed after use): ppt-v1's random weights (seed 0)
   written in fp16 in the reference's directory layout with the port's
   safetensors writer, loaded by ``powerpaint_tpu_torch.load`` on the
   card (load and host-read GB/s), every tensor bitwise the in-memory
   pipeline's and one 20-step DDIM image bitwise its image; a kohya LoRA
   (rank 8, alpha 4, scale 0.8: every UNet attention and feed-forward
   projection, every CLIP self-attention projection, a LoCon on every
   ResNet conv) merged (seconds), nothing unmatched, the image changed,
   a per-call scale of 0.3 restoring every weight and the image bitwise,
   the unload within one bf16 ulp; a 2-vector textual-inversion token
   that changes the image and leaves other prompts' encodings bitwise;
   the same LoRA on the int8 pipeline, every conv's int8 weights bitwise
   the quantisation of its merged weight and the first evaluation's int8
   units within ``int8_check`` of their plain versions; then ppt-v2's
   two-directory layout (the task text encoder a ``.bin``) loaded, its
   20-step UniPC image bitwise the in-memory pipeline's. Launches exact
   per call (phase 3's and 4's).
   7e. The call surface (``run_call_surface_path``), full width, bf16:
   ppt-v1's blended embeddings of a 20-step DDIM call given back as
   ``prompt_embeds`` (the image bitwise, the text encoder's 25 LayerNorms
   not launched), a callback every 5 steps (called at 0, 5, 10, 15 with
   (1, 64, 64, 4) copies; image and launches unchanged); a portrait call,
   a 640 x 480 input to ``height=768, width=512``, in bf16 (seconds and the
   denoise loop's device ms beside 512^2's) and int8 (the split from
   ``int8_site`` at that shape, the first evaluation's int8 units within
   ``int8_check``); the native blend of the portrait result against numpy
   and the native BPE's ids against the Python BPE's; a full-width
   ControlNet (seed 1) written in fp16 as a diffusers directory and loaded
   by ``load_controlnet`` (every tensor the source as the pipelines cast
   it; load GB/s), a portrait call over the ppt-v1 stack, and
   ``serve.cli.main --control_type hed``, then ``canny``, with
   ``--controlnet_dir`` on the demo stack; ppt-v2's ``prompt_embeds`` (the
   task tower not launched) and the 18-step custom ``timesteps=`` grid at
   768 x 512 (18 evaluations), and
   ``timesteps=`` refused on DDIM. Launches exact per call.
   7f. The VAE extras and the approximation modes
   (``run_vae_extras_path``), full width, bf16: ppt-v1 with the
   asymmetric VAE of ``cross-attention/asymmetric-autoencoder-kl-x-1-5``
   (decoder widths 192-768, 4 resnets an up block, a 5-conv condition
   tower whose features match the decoder's blend shapes, checked on the
   card), 20 DDIM steps: two tasks and a bitwise repeat; its decode's
   seconds and device ms beside the SD1.5 decoder's; on the card, an
   all-hole mask decodes two images bitwise alike and a half mask does
   not; the stack written in fp16 in the ppt-v1 layout and loaded (every
   tensor and the image bitwise); one int8 call (the decoder split by
   ``int8_site``). ``decode_tiled`` on the SD1.5 VAE: a 2048^2 canvas in
   25 tiles of 64 with overlap 16 and in one pass (mid attention at S =
   65536), a 768 x 512 canvas in 2 tiles (seconds, device ms, peak memory,
   launches exact per decode). ppt-v1 at ``encoder_cache_interval`` 1, 2, 4
   and ppt-v2 at ``branch_cache_interval`` 2 (launches exact: key steps
   the whole model, other steps the UNet's mid and up blocks or the base
   UNet alone; denoise device ms and PSNR against interval 1), FreeU on
   ppt-v1 (the image changes, the launches do not), and ControlNet's
   refusal of an encoder cache. Phase 2 checks flash attention at the
   asymmetric decoders' head dims 768 and 1024 (batch invariance at 768),
   and the convs and GroupNorm at its 6, 12 and 24 channels a group.
   7g. The adapters (``run_adapter_path``), full published width, bf16,
   random fp16-valued weights from seeds, 512^2, 20 UniPC steps, guidance
   7.5: IP-Adapter on phase 7d's ppt-v2 stack with the OpenCLIP ViT-H/14
   image tower (1280 wide, 32 layers of 16 heads, MLP 5120, ``gelu``,
   projection 1024, 224 px) and two ip-adapter_sd15 adapters (a 1024 -> 4 x
   768 projection and LayerNorm, 16 ``to_k_ip`` / ``to_v_ip`` pairs): no
   adapter, an image twice (bitwise), embeddings (the image changes),
   scale 0 (bitwise the no-adapter image), two adapters with the second at
   0 (bitwise the first alone), a two-request batch; launches exact (16
   more flash attentions and one more LayerNorm per evaluation for each
   adapter, the tower's 66 LayerNorms per encoded image); seconds per
   image, the encode's seconds, the denoise loop's device ms by family with
   and without an adapter. The T2I-Adapter (SD1.5 full adapter, cuDNN
   convs) on a 512^2 map to its 64^2 ... 8^2 features, and one CFG
   evaluation of the v2 base UNet with them (shapes, zero features bitwise
   no adapter, launches exact, device ms). The stack written in fp16 as a
   v2 directory with ``ip_adapter.safetensors`` and ``image_encoder/``
   (``config.json``: 16 heads, ``gelu``), loaded by
   ``powerpaint_tpu_torch.load`` (every tensor bitwise the in-memory
   stack's, the tower's config from its file) and one call bitwise the
   in-memory image. Phase 2 checks flash attention at the four S_kv = 4
   shapes (timed beside SDPA; batch invariance) and LayerNorm at the
   tower's (B, 257, 1280) rows and the projection's (4, 4, 768).
   7h. Serving (``run_serving_path``), full width, bf16, 512^2, 20 steps:
   ``submit()`` under ``torch.cuda.set_sync_debug_mode("error")`` (no
   synchronising call between a call's entry and its final copy) on
   ppt-v1 DDIM (bitwise phase 3's image), ppt-v1 euler_a, ppt-v2 UniPC and
   ppt-v1 + ControlNet, each ``result()`` bitwise the ``__call__`` image,
   with the seconds until ``submit()`` and ``result()`` return beside the
   call's; ``serve.app.make_server`` in this process: ``/health``, phase
   3's request as ``POST /inpaint`` (the PNG bitwise its blended image), a
   400; micro-batched: four concurrent requests sent while one runs, one
   batch of 4, each within Queue C's batch-vs-alone bound of its request
   alone; eight at once against eight one by one (images per second). The
   cold start in two processes, each in a fresh copy of the port: the
   one-shot command builds its kernels and dumps ``--aot-cache``, then
   ``--serve --micro-batch 4 --aot-cache`` loads it (no nvcc) and answers
   the same request bitwise; seconds from each process's start to its
   first image. Launches exact per in-process call.
   7i. Training (``run_train_path``), full width, 512^2, batch 2, bf16
   compute with fp32 master weights, random weights from seeds, synthetic
   batches (``train.data``): three steps each of ``v1``, ``task_tokens``,
   ``lora`` (rank 8), ``lcm_distill`` on ppt-v1 and ``v2`` on ppt-v2, four
   of ``v1`` with accumulate 2 and EMA 0.9 (params move on every second
   call, the EMA on each); per step the loss, grad_norm, seconds and
   forward launches (exact: the backward recomputes plain versions and
   launches no hand kernel), per mode one profiled step's device ms by
   family and its top kernels, and peak memory. Frozen tensors bitwise
   unchanged, every trained tensor moved, the teacher of LoRA and
   distillation untouched. The trained v1 weights written in the reference
   layout, loaded by ``load_ppt_v1`` and served: one 20-step image bitwise
   the in-memory stack's. ``task_tokens`` run again with a save and a load
   after two steps: within lr per step of the straight run (logged
   whether bitwise). The LoRA exported and merged by ``load_lora_weights``
   (the serve CLI's ``--lora``) with nothing unmatched. The train CLI in a
   subprocess (``--mode lora --steps 2 --batch_size 1``), its
   ``lora.npz`` served the same way.
   7j. The mesh (``run_mesh_path``): ppt-v1 at full width, 512^2, bf16,
   over processes on this one card (``powerpaint_tpu_torch.parallel``).
   Two gloo ranks on the card (NCCL refuses two ranks on one device):
   (a) data 1 x model 2, a 4-step DDIM image within max 18 / mean 2.0
   uint8 of the one-process call, the flash kernel at 4 of the 8 heads;
   (b) data 2 x model 1, seeds 1 and 2, each image bitwise the
   one-process call of its seed; each rank's B1-B5 launches; (c) a ZeRO-3
   v1 train step at data 2 (global batch 2) against the one-process step:
   loss to 1e-3, the task-token rows to the JAX post-Adam bound, the
   large leaves' master, moments and EMA about half a rank at rest. (d)
   One NCCL rank: the data-parallel and the ZeRO-3 step bitwise the plain
   step. (e) Sequence parallelism: ppt-v1 on one 1024^2 canvas whose rows
   the two ranks split (``sequence_parallel=True``, ``sp_min_seq`` 2048:
   the UNet's levels 0 and 1 and the VAE's mid attention ride the ring,
   level 2 gathers K and V), 4 DDIM steps, within max 18 / mean 2.0
   uint8 of the one-process call, each rank launching the ring's flash
   mode, GroupNorm's moments mode, B2 and B5; seconds and peak bytes a
   rank against the one-process call, the copies staged through pinned
   memory; the ring alone at the canvas's level-0, level-1 and VAE
   attention against one flash launch over the whole K/V, to 2^-7 of the
   output's largest value and of its 2-norm. No scaling
   is measured: the ranks share one card.
   7k. The bf16-softmax experiment's entry point,
   ``scripts/torch_perf_attn_bf16.py``, through its ``main()``: B1 and the
   flash kernel's bf16-softmax mode at the TPU script's three shapes,
   each kernel's error against dense fp32 softmax, the mode against its
   plain version with B1 as the control (the script exits on a miss);
   it launches B1 and the mode and no other kernel, and no other path
   launches the mode. Its rows are the mode's times in the kernels
   line.
8. Tiny configurations (ppt-v1, ppt-v2, ppt-v1 + ControlNet, each also
   with one other sampler: euler_a at strength 0.6, LCM on an LCM UNet,
   heun with a window; ppt-v1 with int8; ppt-v1 with the asymmetric VAE,
   encoder propagation and FreeU; ppt-v2 with the branch's cache; ppt-v2
   with two IP-Adapters given an image each; a served request through
   ``serve.app._run_request`` on ppt-v1) must give the same image through
   the kernels as through the plain versions on the CPU. Then training
   (``tiny_train_reference``): three steps of ``v1``, ``v2`` and ``lora``
   at the tiny configs in fp32 through the kernels on the card against the
   same steps on the CPU (loss, the first step's gradients, the
   parameters), within the bounds its docstring states.
9. The ``{"kernels": [...]}`` line, then the last line
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


START = time.perf_counter()


def log(**fields) -> None:
    """One JSON line; ``at_s``: seconds since the script started."""
    fields["at_s"] = round(time.perf_counter() - START, 2)
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


# The card's SM count and its top SM clock in Hz (nvidia-smi), set in main().
SM_COUNT = [132]
SM_CLOCK_HZ = [1.98e9]
# nvidia-smi's "name, power.limit" of the card, set in main()
CARD = ["not read"]


def read_card() -> str:
    """nvidia-smi's "name, power.limit" of card 0, with ``CARD``,
    ``SM_COUNT`` and ``SM_CLOCK_HZ`` set from the card."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    CARD[0] = smi
    SM_COUNT[0] = torch.cuda.get_device_properties(0).multi_processor_count
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True).stdout.strip().splitlines()
    if clock and clock[0].strip().isdigit():
        SM_CLOCK_HZ[0] = float(clock[0]) * 1e6
    return smi


def exp2_floor_ms(n_exp2: float) -> float:
    """Least time for ``n_exp2`` MUFU.EX2 (one per attention score) at 16
    per SM per clock, the card's SM count and top clock: a second bound of
    attention beside the tensor-core one, which ``bound_ms`` does not
    count."""
    return n_exp2 / (16.0 * SM_COUNT[0] * SM_CLOCK_HZ[0]) * 1e3


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
    # a 768 x 512 (portrait) image: self-attention at the first two levels,
    # the cross-attention at the first, and the VAE's mid attention
    (2, 6144, 6144, 8, 40), (2, 1536, 1536, 8, 80), (2, 6144, 77, 8, 40),
    (1, 6144, 6144, 1, 512),
    # the asymmetric VAE decoders' one head: x-1-5 (768) and x-2 (1024) at
    # 512^2, and a ragged S
    (1, 4096, 4096, 1, 768), (1, 4096, 4096, 1, 1024), (1, 1000, 1000, 1, 768),
]
# the IP-Adapter's image attention: the UNet's queries at its four levels
# over ip-adapter_sd15's 4 image tokens, under CFG
IP_ATTN_SHAPES = [(2, 4096, 4, 8, 40), (2, 1024, 4, 8, 80),
                  (2, 256, 4, 8, 160), (2, 64, 4, 8, 160)]
ATTN_SHAPES += IP_ATTN_SHAPES
# phase 7j's tensor-parallel ranks: the UNet's self-attention at its first
# two levels with 4 of the 8 heads (tp = 2)
TP_ATTN_SHAPES = [(2, 4096, 4096, 4, 40), (2, 1024, 1024, 4, 80)]
ATTN_SHAPES += TP_ATTN_SHAPES
# (shape (B, S, C), eps, silu): ResNet norms at each UNet level, the widest
# up-block concat, the transformer input norm, and the VAE's largest maps.
GN_SHAPES = [
    ((2, 4096, 320), 1e-5, True), ((2, 4096, 960), 1e-5, True),
    ((2, 1024, 640), 1e-5, True), ((2, 256, 1280), 1e-5, True),
    ((2, 64, 2560), 1e-5, True), ((2, 4096, 320), 1e-6, False),
    ((1, 262144, 128), 1e-6, True), ((1, 65536, 256), 1e-6, True),
    ((1, 4096, 512), 1e-6, False),
    # a 768 x 512 image: the UNet's first level, the VAE's largest map
    ((2, 6144, 320), 1e-5, True), ((1, 393216, 128), 1e-6, True),
    # the asymmetric x-1-5 decoder: 6, 12 and 24 channels a group
    ((1, 262144, 192), 1e-6, True), ((1, 262144, 384), 1e-6, True),
    ((1, 65536, 768), 1e-6, True), ((1, 4096, 768), 1e-6, False),
]
# The log-sum-exp mode of the flash kernel at a ring hop's shapes on a
# 1024^2 canvas split two ways (phase 7j (e)): the UNet's level-0 and
# level-1 self-attention (half the 16384 or 4096 queries against a rank's
# block of keys; D = 40 and 80 are separate instantiations) and the VAE's
# one-head mid attention. The log-sum-exp's relative bound: fp32 logits
# summed in another order (fp32), the bf16 kernel's q rounded to bf16
# after the scale (bf16).
LSE_ATTN_SHAPES = [(2, 8192, 8192, 8, 40), (2, 2048, 2048, 8, 80),
                   (1, 8192, 8192, 1, 512)]
LSE_RTOL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}
# The mode's fp32 output, held to its own size with no floor: the largest
# |difference| over the largest |output|, and the difference's 2-norm over
# the output's, each within the bound. fp32: the same arithmetic in
# another order. bf16: the kernel rounds q * scale and the probabilities
# to bf16 (2^-9 each, the logits' error scaled by their size of a few);
# emulating those roundings on the CPU at the level-0, level-1 and VAE
# shapes gives 0.0023-0.0035 of the largest output and 0.0023-0.0024 of
# the 2-norm, so 2^-7 (0.0078). There a softmax scale off by a tenth
# gives 0.24-0.57 and 0.15-0.16, and half the keys left out about 1.
LSE_OUT_RTOL = {torch.float32: 2.0 ** -14, torch.bfloat16: 2.0 ** -7}
# The flash kernel's bf16-softmax mode (scripts/torch_perf_attn_bf16.py),
# checked against its plain version at the UNet's self-attention of its
# first three levels, a ragged S off every tile and the VAE's one head, as
# (B, Sq, Skv, N, D).
BSM_ATTN_SHAPES = [(2, 4096, 4096, 8, 40), (2, 1024, 1024, 8, 80),
                   (2, 256, 256, 8, 160), (1, 1000, 1000, 2, 40),
                   (1, 4096, 4096, 1, 512)]
# Its bound against the plain version (``attention_errors``, no floor). The
# plain version takes p as the card's bf16x2 exp2 gives it (exp2 in fp32
# cut toward zero), so the two differ only where an fp32 score or sum,
# summed in another order, rounds to another bf16: a bf16 step of an
# output at most (2^-8 of the largest), a small share of the rows in the
# norm. The control, B1 (the fp32 softmax) on the same inputs, must miss
# the norm bound: where it did not, the check could not tell the mode from
# B1. At BSM_ATTN_SHAPES on an H100 the mode read 0.0015-0.0052 of the
# largest output and 8.6e-5-3.2e-4 of the norm, B1 0.0070-0.0183 and
# 0.0053-0.0058 (PERF.md §6 has the script's readings beside these).
BSM_RTOL = {"max_rel_err": 2.0 ** -7, "norm_rel_err": 2.0 ** -9}


def bsm_within(err: dict) -> bool:
    """Whether ``attention_errors`` of the bf16-softmax mode against its
    plain version are within ``BSM_RTOL``."""
    return all(err[k] <= t for k, t in BSM_RTOL.items())


# GroupNorm's sequence-parallel modes at a rank's rows of that canvas: the
# UNet's first level (ResNet and transformer norms), its widest concat,
# the VAE's largest map and its mid block
SP_GN_SHAPES = [((2, 8192, 320), 1e-5, True), ((2, 8192, 960), 1e-5, True),
                ((1, 524288, 128), 1e-6, True), ((1, 8192, 512), 1e-6, False)]


def library_lse_ms(qt, kt, vt):
    """(ms, name) of one ATen call that returns attention's output and its
    log-sum-exp for (B, N, S, D) inputs: the flash backend's op where it
    takes the head dim, else the memory-efficient one's; (None, reason)
    where neither does."""
    aten = torch.ops.aten
    calls = (("aten._scaled_dot_product_flash_attention",
              lambda: aten._scaled_dot_product_flash_attention(qt, kt, vt)),
             ("aten._scaled_dot_product_efficient_attention",
              lambda: aten._scaled_dot_product_efficient_attention(
                  qt, kt, vt, None, True)))
    refused = []
    for name, fn in calls:
        try:
            fn()
            torch.cuda.synchronize()
        except RuntimeError as e:
            refused.append(f"{name}: {str(e).splitlines()[0][:80]}")
            continue
        return graph_ms(fn), name
    return None, "; ".join(refused)


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
        (1, 512, 512, 128, 128, 32), (1, 8, 8, 48, 40, 24),
        # H != W: a 768 x 512 image's first UNet level and deep level
        (2, 96, 64, 320, 320, 32), (2, 12, 8, 1280, 1280, 32),
        # the asymmetric x-1-5 decoder's units at 6, 12 and 24 channels a
        # group
        (1, 512, 512, 192, 192, 32), (1, 512, 512, 384, 192, 32),
        (1, 256, 256, 768, 384, 32), (1, 64, 64, 768, 768, 32)],
    "conv3x3": [
        (2, 64, 64, 640, 640, 0), (2, 16, 16, 1280, 1280, 0),
        (1, 512, 512, 256, 256, 0), (2, 64, 64, 320, 320, 0),
        (1, 8, 8, 48, 40, 0), (2, 96, 64, 640, 640, 0),
        # the asymmetric decoder's upsampler convs
        (1, 512, 512, 384, 384, 0), (1, 256, 256, 768, 768, 0)],
}
# (B, H, W, Cin, Cout, groups): the int8 form (with and without the
# prologue) at ResNet units the JAX package quantises at a 512x512 image:
# the UNet's first level, its widest int8 up-block concat, the deep levels,
# and the VAE encoder's (256, 128 -> 256); then a ragged fp32-only shape.
INT8_SHAPES = [(2, 64, 64, 320, 320, 32), (2, 64, 64, 960, 320, 32),
               (2, 16, 16, 2560, 1280, 32), (2, 8, 8, 1280, 1280, 32),
               (1, 256, 256, 128, 256, 32), (1, 5, 7, 20, 12, 10),
               (2, 96, 64, 320, 320, 32), (2, 24, 16, 1280, 1280, 32)]
X_SCALE = 8.0 / 127.0  # the JAX package's default POWERPAINT_INT8_XSCALE
# (shape, eps): transformer-block norms at each UNet level and CLIP's.
LN_SHAPES = [
    ((2, 4096, 320), 1e-5), ((2, 1024, 640), 1e-5), ((2, 256, 1280), 1e-5),
    ((2, 64, 1280), 1e-5), ((4, 77, 768), 1e-5), ((2, 6144, 320), 1e-5),
]
# the IP-Adapter's rows: the ViT-H/14 tower's 257 tokens of 1280 (one
# image, and two), the projection's 4 tokens of 768 under CFG (2 images x
# 2 adapters)
IP_LN_SHAPES = [((1, 257, 1280), 1e-5), ((2, 257, 1280), 1e-5),
                ((4, 4, 768), 1e-5)]
LN_SHAPES += IP_LN_SHAPES
# The safety checker's LayerNorm rows, fp32 (ViT-L/14: 257 tokens of 1024,
# then the class token alone).
SAFETY_LN_SHAPES = [(1, 257, 1024), (1, 1024)]
# a C off the 16-byte vectors, on rows that start one element off alignment
# (element loads on the same thread-to-element map): checked, not timed
LN_RAGGED = ((3, 7, 300), 1e-5)

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


def sdpa_backend(q, k, v) -> str:
    """Which backend ``scaled_dot_product_attention`` picks for these
    (B, N, S, D) inputs, from the kernel names of one profiled call (its
    flash backend stops at D = 256), with those names."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.nn.functional.scaled_dot_product_attention(q, k, v)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    low = " ".join(names).lower()
    kind = next((k for k, keys in (("cudnn", ("cudnn",)), ("flash", ("flash",)),
                                   ("efficient", ("fmha", "efficient")))
                 if any(x in low for x in keys)), "math")
    return f"{kind}: " + ", ".join(n[:60] for n in names[:3])


def check_kernels(device) -> list:
    from powerpaint_tpu_torch.ops import conv
    from powerpaint_tpu_torch.ops import flash_attention as fa
    from powerpaint_tpu_torch.ops import norms
    from powerpaint_tpu_torch.parallel.dryrun import attention_errors

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
                exp2_floor_ms=exp2_floor_ms(b * n * sq * skv),
                smem_bytes=fa.bf16_config(d)["smem"],
                ms=graph_ms(lambda: fa.flash_attention(q, k, v)),
                stream_ms=cuda_ms(lambda: fa.flash_attention(q, k, v)),
                host_ms=host_ms(lambda: fa.flash_attention(q, k, v)),
                plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v),
                                 iters=5),
                library_ms=graph_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        qt, kt, vt)),
                library_backend=sdpa_backend(qt, kt, vt),
                bound=bound_ms(flops, nbytes)))
    log(phase="kernel checks", kernel="flash_attention",
        seconds=time.perf_counter() - t0)

    # ---- kernel 1, its log-sum-exp mode (ring attention's hops): the fp32
    # output to LSE_OUT_RTOL, the log-sum-exp to LSE_RTOL of the plain one
    t0 = time.perf_counter()
    for (b, sq, skv, n, d) in LSE_ATTN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q = randn(b, sq, n, d, dtype=dtype)
            k = randn(b, skv, n, d, dtype=dtype)
            v = randn(b, skv, n, d, dtype=dtype)
            got, lse = fa.flash_attention_lse(q, k, v)
            torch.cuda.synchronize()
            want, want_lse = fa.flash_attention_lse_plain(q, k, v)
            errs = attention_errors(got, want)
            rtol = LSE_OUT_RTOL[dtype]
            lse_err = float(((lse - want_lse) / want_lse.abs()).abs().max())
            check(got.dtype == lse.dtype == torch.float32,
                  f"flash_attention_lse: {got.dtype} out, {lse.dtype} lse")
            record("flash_attention_lse", (b, sq, skv, n, d), dtype,
                   errs.pop("max_abs_err"),
                   rtol * float(want.abs().max()),
                   ok=max(errs.values()) <= rtol and lse_err <= LSE_RTOL[dtype],
                   **errs, rtol=rtol, lse_max_rel_err=lse_err,
                   lse_rtol=LSE_RTOL[dtype])
            del want, want_lse
            if dtype != torch.bfloat16:
                continue
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            flops = 4.0 * b * n * sq * skv * d
            # q, k, v read in bf16; the fp32 output and log-sum-exp written
            nbytes = 2.0 * (b * sq * n * d + 2 * b * skv * n * d) + \
                4.0 * (b * sq * n * d + b * n * sq)
            lib_ms, lib_name = library_lse_ms(qt, kt, vt)
            timings.setdefault("flash_attention_lse", []).append(dict(
                shape=[b, sq, skv, n, d],
                exp2_floor_ms=exp2_floor_ms(b * n * sq * skv),
                ms=graph_ms(lambda: fa.flash_attention_lse(q, k, v)),
                stream_ms=cuda_ms(lambda: fa.flash_attention_lse(q, k, v)),
                host_ms=host_ms(lambda: fa.flash_attention_lse(q, k, v)),
                plain_ms=cuda_ms(lambda: fa.flash_attention_lse_plain(q, k, v),
                                 iters=3),
                library_ms=lib_ms, library_scope=lib_name,
                bound=bound_ms(flops, nbytes)))
            torch.cuda.empty_cache()
    log(phase="kernel checks", kernel="flash_attention_lse",
        seconds=time.perf_counter() - t0)

    # ---- kernel 1, its bf16-softmax mode (the TPU script's kernel): held to
    # its plain version at the kernel's block of keys, B1 on the same inputs
    # the control (timed at the script's shapes by phase 7k)
    t0 = time.perf_counter()
    name = "flash_attention_bf16_softmax"
    for (b, sq, skv, n, d) in BSM_ATTN_SHAPES:
        q, k, v = (randn(b, s, n, d, dtype=torch.bfloat16) for s in (sq, skv, skv))
        got = fa.flash_attention_bf16_softmax(q, k, v)
        torch.cuda.synchronize()
        want = fa.flash_attention_bf16_softmax_plain(q, k, v)
        errs = attention_errors(got, want)
        control = attention_errors(fa.flash_attention(q, k, v), want)
        record(name, (b, sq, skv, n, d), torch.bfloat16, errs["max_abs_err"],
               BSM_RTOL["max_rel_err"] * float(want.float().abs().max()),
               ok=bsm_within(errs), **{k: errs[k] for k in BSM_RTOL},
               rtol=BSM_RTOL, block_kv=fa.bf16_config(d)["bk"],
               control_b1=control)
        check(not bsm_within(control), f"{name} {(b, sq, skv, n, d)}: B1's "
              f"output is within the mode's bound too ({control})")
        del got, want
    log(phase="kernel checks", kernel=name, seconds=time.perf_counter() - t0)

    # ---- kernel 2: GroupNorm in its four modes (csrc/group_norm.cu)
    t0 = time.perf_counter()
    sms = SM_COUNT[0]
    for shape, eps, silu in GN_SHAPES:
        b, sz, c = shape
        for dtype in (torch.float32, torch.bfloat16):
            x = (randn(*shape) * 2 - 0.3).to(dtype)
            w = 1 + 0.1 * randn(c)
            bb = 0.1 * randn(c)
            kw = dict(num_groups=32, eps=eps, silu=silu)
            qkw = dict(num_groups=32, eps=eps, x_scale=X_SCALE)
            plan = norms.gn_plan(sz, c, 32, x.element_size(), sms=sms)
            form = dict(form="resident" if plan["resident"] else "streamed",
                        cluster=plan["cluster"], span=plan["span"],
                        blocks=b * (plan["spans"] * plan["cluster"] if plan["resident"]
                                    else plan["chunks"]))
            got = norms.group_norm(x, w, bb, **kw)
            torch.cuda.synchronize()
            want = norms.group_norm_plain(x, w, bb, **kw)
            err = float((got.float() - want.float()).abs().max())
            record("group_norm", shape, dtype, err, tolerance(dtype, want), **form)
            # the statistics: every mode's bits equal, close to the plain ones
            stats = [norms._launch_gn(x, None, None, 32, eps, 0)[1],
                     norms._launch_gn(x, w, bb, 32, eps, 1, silu=silu)[1],
                     norms._launch_gn(x, w, bb, 32, eps, 2, x_scale=X_SCALE)[1]]
            mean, rstd = norms.group_norm_stats(x, 32, eps)
            same = all(torch.equal(st, stats[0]) for st in stats) and \
                torch.equal(mean, stats[0][0]) and torch.equal(rstd, stats[0][1])
            p_mean, p_rstd = norms.group_norm_stats_plain(x, 32, eps)
            err = max(float((mean - p_mean).abs().max()),
                      float(((rstd - p_rstd) / p_rstd).abs().max()))
            record("group_norm_stats", shape, dtype, err, 1e-4,
                   ok=err <= 1e-4 and same, modes_bitwise_equal=same, **form)
            # the quantisers: bitwise their plain versions
            q = norms.gn_silu_quantize_int8(x, w, bb, **qkw)
            want_q = norms.gn_silu_quantize_int8_plain(x, w, bb, **qkw)
            err = float((q.float() - want_q.float()).abs().max())
            record("gn_silu_quantize_int8", shape, dtype, err, 0.0,
                   ok=torch.equal(q, want_q),
                   levels_differing=int((q != want_q).sum()), **form)
            q = norms.quantize_int8(x, x_scale=X_SCALE)
            want_q = norms.quantize_int8_plain(x, x_scale=X_SCALE)
            err = float((q.float() - want_q.float()).abs().max())
            record("quantize_int8", shape, dtype, err, 0.0, ok=torch.equal(q, want_q),
                   levels_differing=int((q != want_q).sum()))
            if dtype != torch.bfloat16:
                continue
            # ATen's NCHW group norm on the channels-last view
            x_nchw = x.reshape(b, -1, 1, c).permute(0, 3, 1, 2)
            wl, bl = w.to(dtype), bb.to(dtype)
            inv = norms.inv_scale(X_SCALE)
            F = torch.nn.functional

            def library(x_nchw=x_nchw, wl=wl, bl=bl, eps=eps, silu=silu):
                y = F.group_norm(x_nchw, 32, wl, bl, eps)
                return F.silu(y) if silu else y

            def library_q(x_nchw=x_nchw, wl=wl, bl=bl, eps=eps):
                y = F.silu(F.group_norm(x_nchw.float(), 32, wl.float(), bl.float(), eps))
                return torch.clamp(torch.round(y * inv), -127, 127).to(torch.int8)

            xg = x.reshape(b, -1, 32, c // 32)
            n_el = float(x.numel())
            iters = 5 if x.numel() >= 2 ** 24 else 20
            gt = lambda fn: graph_ms(fn, iters=iters)
            rows = (
                ("group_norm", lambda: norms.group_norm(x, w, bb, **kw),
                 lambda: norms.group_norm_plain(x, w, bb, **kw), library,
                 "F.group_norm" + (" then F.silu" if silu else ""), 4.0 * n_el),
                ("group_norm_stats", lambda: norms.group_norm_stats(x, 32, eps),
                 lambda: norms.group_norm_stats_plain(x, 32, eps),
                 lambda: torch.var_mean(xg, dim=(1, 3), correction=0),
                 "torch.var_mean over the groups (variance, not its 1/sqrt)",
                 2.0 * n_el),
                ("gn_silu_quantize_int8", lambda: norms.gn_silu_quantize_int8(x, w, bb, **qkw),
                 lambda: norms.gn_silu_quantize_int8_plain(x, w, bb, **qkw), library_q,
                 "F.group_norm, F.silu, then round, clamp and int8 in fp32 (a chain)",
                 3.0 * n_el),
                ("quantize_int8", lambda: norms.quantize_int8(x, x_scale=X_SCALE),
                 lambda: norms.quantize_int8_plain(x, x_scale=X_SCALE),
                 lambda: torch.clamp(torch.round(x * inv), -127, 127).to(torch.int8),
                 "round, clamp and int8 (a chain)", 3.0 * n_el))
            for name, fn, ref, lib, scope, nbytes in rows:
                timings.setdefault(name, []).append(dict(
                    shape=list(shape), silu=silu or name == "gn_silu_quantize_int8",
                    **form, ms=gt(fn), stream_ms=cuda_ms(fn, iters=iters),
                    host_ms=host_ms(fn, iters=iters), plain_ms=cuda_ms(ref, iters=iters),
                    library_ms=gt(lib), library_scope=scope,
                    bound=bound_ms(0.0, nbytes)))
    log(phase="kernel checks", kernel="group_norm",
        seconds=time.perf_counter() - t0)

    # ---- GroupNorm's sequence-parallel modes at the rows a rank holds of a
    # 1024^2 canvas split two ways: the moments (mean, M2) against the plain
    # two-pass moments to 1e-5, the apply and the quantiser from given
    # statistics against their plain versions (the apply to B3's bound,
    # the quantiser bitwise)
    t0 = time.perf_counter()
    for shape, eps, silu in SP_GN_SHAPES:
        b, sz, c = shape
        for dtype in (torch.float32, torch.bfloat16):
            x = (randn(*shape) * 2 - 0.3).to(dtype)
            w = 1 + 0.1 * randn(c)
            bb = 0.1 * randn(c)
            mean, m2 = norms.group_norm_moments(x, 32)
            torch.cuda.synchronize()
            p_mean, p_m2 = norms.group_norm_moments_plain(x, 32)
            err = max(float(((mean - p_mean).abs() / (p_mean.abs() + 1.0)).max()),
                      float(((m2 - p_m2) / p_m2).abs().max()))
            record("group_norm_moments", shape, dtype, err, 1e-5)
            stats = (p_mean, 1.0 / torch.sqrt(p_m2 / (sz * (c // 32)) + eps))
            kw = dict(num_groups=32, eps=eps, silu=silu)
            got = norms.group_norm(x, w, bb, stats=stats, **kw)
            torch.cuda.synchronize()
            want = norms.group_norm_plain(x, w, bb, stats=stats, **kw)
            err = float((got.float() - want.float()).abs().max())
            record("group_norm", shape, dtype, err, tolerance(dtype, want),
                   given_statistics=True)
            qkw = dict(num_groups=32, eps=eps, x_scale=X_SCALE, stats=stats)
            q = norms.gn_silu_quantize_int8(x, w, bb, **qkw)
            want_q = norms.gn_silu_quantize_int8_plain(x, w, bb, **qkw)
            record("gn_silu_quantize_int8", shape, dtype,
                   float((q.float() - want_q.float()).abs().max()), 0.0,
                   ok=torch.equal(q, want_q), given_statistics=True,
                   levels_differing=int((q != want_q).sum()))
            if dtype != torch.bfloat16:
                continue
            xg = x.reshape(b, -1, 32, c // 32)
            n_el = float(x.numel())
            iters = 5 if x.numel() >= 2 ** 24 else 20
            fn = lambda x=x: norms.group_norm_moments(x, 32)  # noqa: E731
            timings.setdefault("group_norm_moments", []).append(dict(
                shape=list(shape), ms=graph_ms(fn, iters=iters),
                stream_ms=cuda_ms(fn, iters=iters),
                host_ms=host_ms(fn, iters=iters),
                plain_ms=cuda_ms(lambda x=x: norms.group_norm_moments_plain(
                    x, 32), iters=iters),
                library_ms=graph_ms(lambda xg=xg: torch.var_mean(
                    xg, dim=(1, 3), correction=0), iters=iters),
                library_scope="torch.var_mean over the groups (variance "
                              "and mean, not M2)",
                bound=bound_ms(0.0, 2.0 * n_el)))
            for name, fn, ref in (
                    ("group_norm", lambda x=x, w=w, bb=bb, kw=kw: norms.group_norm(
                        x, w, bb, stats=stats, **kw),
                     lambda x=x, w=w, bb=bb, kw=kw: norms.group_norm_plain(
                        x, w, bb, stats=stats, **kw)),
                    ("gn_silu_quantize_int8",
                     lambda x=x, w=w, bb=bb, qkw=qkw: norms.gn_silu_quantize_int8(
                        x, w, bb, **qkw),
                     lambda x=x, w=w, bb=bb, qkw=qkw: norms.gn_silu_quantize_int8_plain(
                        x, w, bb, **qkw))):
                timings.setdefault(name + " (given statistics)", []).append(dict(
                    shape=list(shape), given_statistics=True,
                    ms=graph_ms(fn, iters=iters),
                    plain_ms=cuda_ms(ref, iters=iters),
                    bound=bound_ms(0.0, (4.0 if name == "group_norm" else 3.0)
                                   * n_el)))
    log(phase="kernel checks", kernel="group_norm sequence-parallel modes",
        seconds=time.perf_counter() - t0)

    # ---- kernel 3: LayerNorm (csrc/layer_norm.cu)
    t0 = time.perf_counter()
    for shape, eps in LN_SHAPES + [LN_RAGGED]:
        c = shape[-1]
        ragged = (shape, eps) == LN_RAGGED
        for dtype in (torch.float32, torch.bfloat16):
            x = (randn(*shape) * 3 + 0.5).to(dtype)
            if ragged:
                x = torch.cat([x.new_zeros(1), x.flatten()])[1:].view(shape)
            w = 1 + 0.1 * randn(c)
            bb = 0.1 * randn(c)
            p = norms.ln_plan(c, x.element_size())
            cut = dict(group=p["group"], vecs=p["vecs"], threads=p["threads"])
            got = norms.layer_norm(x, w, bb, eps=eps)
            torch.cuda.synchronize()
            want = norms.layer_norm_plain(x, w, bb, eps=eps)
            err = float((got.float() - want.float()).abs().max())
            record("layer_norm", shape, dtype, err, tolerance(dtype, want),
                   misaligned=ragged, **cut)
            if dtype != torch.bfloat16 or ragged:
                continue
            wl, bl = w.to(dtype), bb.to(dtype)
            nbytes = 2.0 * 2 * x.numel() + 2 * 4 * c  # x, y; fp32 gamma, beta
            timings.setdefault("layer_norm", []).append(dict(
                shape=list(shape), **cut,
                ms=graph_ms(lambda: norms.layer_norm(x, w, bb, eps=eps)),
                stream_ms=cuda_ms(lambda: norms.layer_norm(x, w, bb, eps=eps)),
                host_ms=host_ms(lambda: norms.layer_norm(x, w, bb, eps=eps)),
                plain_ms=cuda_ms(lambda: norms.layer_norm_plain(x, w, bb, eps=eps)),
                library_ms=graph_ms(lambda: torch.nn.functional.layer_norm(
                    x, (c,), wl, bl, eps)),
                bound=bound_ms(0.0, nbytes)))
    log(phase="kernel checks", kernel="layer_norm",
        seconds=time.perf_counter() - t0)

    # ---- GroupNorm and LayerNorm at the annotator path's shapes, in fp32
    # (the type those forwards run in): every distinct (S, C) of the
    # DPT-hybrid forward's BiT GroupNorms at 384^2, from the config (32
    # groups, eps 1e-5, no SiLU; 2 channels a group at the stem), and the
    # safety checker's LayerNorm rows
    from powerpaint_tpu_torch.core.config import dpt_hybrid_midas_config
    from powerpaint_tpu_torch.models.dpt import gn_shapes

    t0 = time.perf_counter()
    F = torch.nn.functional
    for sz, c in dict.fromkeys(gn_shapes(dpt_hybrid_midas_config(), 384, 384)):
        x = randn(1, sz, c) * 2 - 0.3
        w = 1 + 0.1 * randn(c)
        bb = 0.1 * randn(c)
        kw = dict(num_groups=32, eps=1e-5, silu=False)
        plan = norms.gn_plan(sz, c, 32, 4, sms=SM_COUNT[0])
        form = dict(form="resident" if plan["resident"] else "streamed",
                    cluster=plan["cluster"], span=plan["span"])
        got = norms.group_norm(x, w, bb, **kw)
        torch.cuda.synchronize()
        want = norms.group_norm_plain(x, w, bb, **kw)
        err = float((got - want).abs().max())
        record("group_norm", (1, sz, c), torch.float32, err, 1e-4, path="dpt", **form)
        fn = lambda x=x, w=w, bb=bb: norms.group_norm(x, w, bb, **kw)  # noqa: E731
        x_nchw = x.reshape(1, -1, 1, c).permute(0, 3, 1, 2)
        timings["group_norm"].append(dict(
            shape=[1, sz, c], dtype="float32", path="dpt", silu=False, **form,
            ms=graph_ms(fn), stream_ms=cuda_ms(fn), host_ms=host_ms(fn),
            plain_ms=cuda_ms(lambda x=x, w=w, bb=bb: norms.group_norm_plain(
                x, w, bb, **kw)),
            library_ms=graph_ms(lambda x_nchw=x_nchw, w=w, bb=bb: F.group_norm(
                x_nchw, 32, w, bb, 1e-5)),
            library_scope="F.group_norm (fp32)",
            bound=bound_ms(0.0, 8.0 * x.numel() + 8.0 * c)))
    for shape in SAFETY_LN_SHAPES:
        c = shape[-1]
        x = randn(*shape) * 3 + 0.5
        w = 1 + 0.1 * randn(c)
        bb = 0.1 * randn(c)
        got = norms.layer_norm(x, w, bb, eps=1e-5)
        torch.cuda.synchronize()
        want = norms.layer_norm_plain(x, w, bb, eps=1e-5)
        err = float((got - want).abs().max())
        p = norms.ln_plan(c, 4)
        cut = dict(group=p["group"], vecs=p["vecs"], threads=p["threads"])
        record("layer_norm", shape, torch.float32, err, 1e-4, path="safety", **cut)
        fn = lambda x=x, w=w, bb=bb: norms.layer_norm(x, w, bb, eps=1e-5)  # noqa: E731
        timings["layer_norm"].append(dict(
            shape=list(shape), dtype="float32", path="safety", **cut,
            ms=graph_ms(fn), stream_ms=cuda_ms(fn), host_ms=host_ms(fn),
            plain_ms=cuda_ms(lambda x=x, w=w, bb=bb: norms.layer_norm_plain(
                x, w, bb, eps=1e-5)),
            library_ms=graph_ms(lambda x=x, w=w, bb=bb: F.layer_norm(
                x, (c,), w, bb, 1e-5)),
            bound=bound_ms(0.0, 8.0 * x.numel() + 8.0 * c)))
    log(phase="kernel checks", kernel="annotator norms",
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
                plan = conv.bf16_plan(b, h, w, cin, cout, sms=SM_COUNT[0])
                extra = {}
                if fused:
                    # evidence for an open question, run by no path: the
                    # GroupNorm kernel's apply mode, then the plain conv
                    extra["unfused_ms"] = graph_ms(lambda: conv.conv3x3(
                        norms.group_norm(x, gamma, beta, num_groups=groups,
                                         eps=1e-5, silu=True), wt, bias),
                        iters=iters)
                timings.setdefault(name, []).append(dict(
                    shape=[b, h, w, cin, cout],
                    bn=plan["bn"], splits=plan["splits"], smem_bytes=plan["smem"],
                    **extra, ms=graph_ms(fn, iters=iters),
                    stream_ms=cuda_ms(fn, iters=iters),
                    host_ms=host_ms(fn, iters=iters),
                    plain_ms=cuda_ms(ref, iters=iters),
                    library_ms=graph_ms(library, iters=iters),
                    bound=bound_ms(flops, nbytes)))
    log(phase="kernel checks", kernel="conv3x3", seconds=time.perf_counter() - t0)

    # ---- kernels 6 and 7: the static-scale int8 units with / without
    # GroupNorm + SiLU: the quantiser, then the int8 conv
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
                # bitwise: the plain version takes the statistics mode's
                # bits and rounds the same IEEE operations
                record(name, (b, h, w, cin, cout), dtype, err,
                       "bitwise (and int8_check's flip bound)",
                       ok=ok and torch.equal(got, want), flip_candidates=flips,
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
                # the unit's two launches apart: the quantiser, then the
                # int8 conv on its output
                quant = ((lambda: norms.gn_silu_quantize_int8(
                    x, *gn, num_groups=groups, eps=1e-5, x_scale=X_SCALE))
                    if fused else (lambda: norms.quantize_int8(x, x_scale=X_SCALE)))
                q = quant()
                plan = conv.int8_plan(b, h, w, cin, cout, sms=SM_COUNT[0])
                timings.setdefault(name, []).append(dict(
                    shape=[b, h, w, cin, cout],
                    bn=plan["bn"], splits=plan["splits"], smem_bytes=plan["smem"],
                    quantize_ms=graph_ms(quant, iters=iters),
                    product_ms=graph_ms(lambda: conv.int8_product(
                        q, w_q, w_s, bias, X_SCALE, dtype), iters=iters),
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
    from powerpaint_tpu_torch.ops import norms

    F = torch.nn.functional
    if fused:
        y = norms.gn_silu_fp32(x, *gn, num_groups=groups, eps=1e-5)
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
    against 1, at fp32 (TF32 off) and bf16. The library calls are logged,
    not checked (a batch-variant library call is not a fault of the port);
    the bf16 flash attention and conv kernels (the wgmma designs), and
    GroupNorm, LayerNorm and the int8 unit at both types, must be bitwise
    invariant and give the same bits on a second run."""
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
    cases.append(("flash_attention, asymmetric VAE head", (4096, 1, 768),
                  lambda x: fa.flash_attention(x, x.flip(1).contiguous(),
                                               x.roll(1, 1).contiguous()), (2, 1)))
    g320, b320 = 1 + 0.1 * randn(320), 0.1 * randn(320)
    cases.append(("group_norm", (4096, 320), lambda x: norms.group_norm(
        x, g320, b320, num_groups=32, eps=1e-6, silu=True)))
    cases.append(("layer_norm", (4096, 320), lambda x: norms.layer_norm(
        x, g320, b320)))
    g768, b768 = 1 + 0.1 * randn(768), 0.1 * randn(768)
    cases.append(("layer_norm, CLIP", (77, 768), lambda x: norms.layer_norm(
        x, g768, b768), (8, 4)))
    cases.append(("flash_attention, text context", (4096, 8, 40),
                  lambda x: fa.flash_attention(x, x[:, :77].contiguous(),
                                               x[:, 77:154].contiguous())))
    cases.append(("flash_attention, image tokens", (4096, 8, 40),
                  lambda x: fa.flash_attention(x, x[:, :4].contiguous(),
                                               x[:, 4:8].contiguous())))
    g1280, b1280 = 1 + 0.1 * randn(1280), 0.1 * randn(1280)
    cases.append(("layer_norm, ViT-H tower", (257, 1280), lambda x: norms.layer_norm(
        x, g1280, b1280), (2, 1)))
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
            bitwise = bool(torch.equal(many[:small], few))
            again = bool(torch.equal(fn(x), many))
            log(batch_invariance=name, shape=list(shape),
                dtype=str(dtype).split(".")[-1], batch=[big, small],
                bitwise=bitwise, deterministic=again,
                max_abs_diff=float(d.max()),
                max_abs_out=float(few.float().abs().max()))
            kernel = name.split(",")[0]
            if kernel in ("group_norm", "layer_norm", "conv3x3_gn_silu_int8") or (
                    dtype == torch.bfloat16 and kernel in (
                        "flash_attention", "conv3x3_gn_silu", "conv3x3")):
                check(bitwise and again, f"{name} {dtype}: batch-variant or "
                      f"nondeterministic (bitwise {bitwise}, repeat {again})")
    torch.backends.cudnn.allow_tf32 = True


# ---------------------------------------------------------------------------
# phases 3 to 7: the main paths
# ---------------------------------------------------------------------------

KERNELS = ("flash_attention", "flash_attention_lse",
           "flash_attention_bf16_softmax", "group_norm_moments",
           "group_norm", "group_norm_stats",
           "gn_silu_quantize_int8", "quantize_int8", "layer_norm",
           "conv3x3_gn_silu", "conv3x3", "conv3x3_gn_silu_int8", "conv3x3_int8")


def unet_launches(u, with_out_norm: bool = True, encoder: bool = True) -> dict:
    """Launches of one UNet (or BrushNet, which has no conv_norm_out)
    evaluation, CFG in the batch: every transformer runs 2 attentions, 3
    LayerNorms and its GroupNorm; every ResNet unit 2 fused GN+SiLU convs,
    each after its GroupNorm statistics launch; every upsampler one plain
    conv. ``encoder`` False: a step on cached encoder features, the mid
    and up blocks alone."""
    n_levels = len(u.block_out_channels)
    n_tf = (sum(k.startswith("CrossAttn") for k in u.down_block_types)
            * u.layers_per_block * int(encoder)
            + sum(k.startswith("CrossAttn") for k in u.up_block_types)
            * (u.layers_per_block + 1) + 1) * u.transformer_layers_per_block
    n_res = (n_levels * u.layers_per_block * int(encoder) + 2
             + n_levels * (u.layers_per_block + 1))
    return {"flash_attention": 2 * n_tf, "layer_norm": 3 * n_tf,
            "group_norm": n_tf + int(with_out_norm),
            "group_norm_stats": 2 * n_res,
            "conv3x3_gn_silu": 2 * n_res, "conv3x3": n_levels - 1}


def controlnet_launches(u) -> dict:
    """One ControlNet branch evaluation on the UNet config ``u``: the down
    and mid half of ``unet_launches`` (its transformers and ResNet units,
    no upsampler, no output norm); the embedding's and the zero convs run
    on cuDNN."""
    n_levels = len(u.block_out_channels)
    n_tf = (sum(k.startswith("CrossAttn") for k in u.down_block_types)
            * u.layers_per_block + 1) * u.transformer_layers_per_block
    n_res = n_levels * u.layers_per_block + 2
    return {"flash_attention": 2 * n_tf, "layer_norm": 3 * n_tf,
            "group_norm": n_tf, "group_norm_stats": 2 * n_res,
            "conv3x3_gn_silu": 2 * n_res, "conv3x3": 0}


def vae_launches(v, decoder: bool) -> dict:
    """One VAE encode or decode: its ResNet units, the mid attention and
    its GroupNorm, the output GroupNorm, the decoder's upsamplers. The
    decoder has its own widths and depth (``up_channels``, ``up_layers``:
    an asymmetric VAE's); its condition tower runs on cuDNN."""
    levels = len(v.up_channels if decoder else v.block_out_channels)
    per = v.up_layers + 1 if decoder else v.layers_per_block
    n_res = levels * per + 2
    return {"flash_attention": 1, "layer_norm": 0, "group_norm": 2,
            "group_norm_stats": 2 * n_res, "conv3x3_gn_silu": 2 * n_res,
            "conv3x3": levels - 1 if decoder else 0}


def _half(n: int) -> int:
    return -(-n // 2)  # the UNet's stride-2 conv with padding 1


def unet_sites(u, h: int, w: int, encoder_only: bool = False,
               encoder: bool = True) -> list:
    """(H, W, Cin, Cout) of every GroupNorm-fed conv (conv1 and conv2 of
    each ResNet unit) of one UNet or BrushNet evaluation on an h x w
    latent: the down levels, the mid block, and the up levels, whose units
    take the running feature concatenated with a skip. ``encoder_only``:
    the down levels and the mid block (a ControlNet branch); ``encoder``
    False: the mid block and the up levels (a step on cached encoder
    features)."""
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
    if not encoder:
        sites.clear()
    unit(sizes[-1], ch[-1], ch[-1])
    unit(sizes[-1], ch[-1], ch[-1])
    if encoder_only:
        return sites
    rev = ch[::-1]
    prev = rev[0]
    for i in range(n):
        for _ in range(per + 1):
            unit(sizes[n - 1 - i], prev + skips.pop(), rev[i])
            prev = rev[i]
    return sites


def vae_sites(v, h: int, w: int, decoder: bool) -> list:
    """The same for one VAE encode (an h x w image) or decode (to one), the
    decoder at its own widths and depth."""
    ch = v.up_channels if decoder else v.block_out_channels
    per = v.up_layers if decoder else v.layers_per_block
    n = len(ch)
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
    sites ``int8_site`` admits move to the int8 unit, their statistics
    launch to its quantiser."""
    from powerpaint_tpu_torch.ops.conv import int8_site

    check(len(sites) == launches["conv3x3_gn_silu"],
          f"{len(sites)} ResNet sites for {launches['conv3x3_gn_silu']} units")
    n = sum(int8_site(*site) for site in sites)
    return {**launches, "conv3x3_gn_silu": len(sites) - n,
            "group_norm_stats": len(sites) - n,
            "conv3x3_gn_silu_int8": n, "gn_silu_quantize_int8": n}


def _total(*parts) -> dict:
    """Sum of (count, launches dict) pairs."""
    return {k: sum(n * d.get(k, 0) for n, d in parts) for k in KERNELS}


def _hw(hw):
    """(H, W) of an image size given as one side or as (H, W)."""
    return (hw, hw) if isinstance(hw, int) else tuple(hw)


def _models(cfg, int8_hw, *unets):
    """Per-evaluation launches of each UNet config in ``unets`` (the first
    with ``conv_norm_out``) and of one VAE encode and decode, split by
    ``int8_split`` at an ``int8_hw`` image (one side, or (H, W)) when int8
    is on."""
    parts = [unet_launches(u, with_out_norm=i == 0) for i, u in enumerate(unets)]
    parts += [vae_launches(cfg.vae, False), vae_launches(cfg.vae, True)]
    if int8_hw is None:
        return parts
    h, w = _hw(int8_hw)
    sites = [unet_sites(u, h // 8, w // 8) for u in unets] + [
        vae_sites(cfg.vae, h, w, False), vae_sites(cfg.vae, h, w, True)]
    return [int8_split(p, s) for p, s in zip(parts, sites)]


def evaluations(cfg, scheduler: str, steps: int, strength: float = 1.0) -> int:
    """UNet evaluations of one call: the sampler's iterations over the kept
    steps (heun 2S-1, pndm S+1, the others S), from its host tables."""
    from powerpaint_tpu_torch.pipelines.common import make_sampler

    kept = min(int(steps * strength), steps)
    return make_sampler(scheduler, cfg.scheduler, steps, kept)[1].num_steps


def key_steps(n: int, interval: int) -> int:
    """Evaluations of ``n`` that run the whole model at a cache
    ``interval`` (iterations i with i % interval == 0; all of them at 1 or
    less)."""
    return n if interval <= 1 else len(range(0, n, interval))


def expected_launches(cfg, steps: int, strength: float = 1.0,
                      int8_hw=None, scheduler: str = "ddim",
                      text_encoder: bool = True,
                      encoder_cache_interval: int = 1) -> dict:
    """Kernel launches one ppt-v1 ``__call__`` implies, from the config: one
    UNet evaluation per sampler iteration over the kept steps (with an
    ``encoder_cache_interval`` above 1, the whole UNet on key steps and its
    mid and up blocks on the others), CLIP's 2 LayerNorms a layer and the
    final one (none when ``text_encoder`` is False: both embeddings given),
    one or two VAE encodes (image latents only at strength < 1) and one
    decode; with int8 on (``int8_hw``, the image's side or its (H, W)), the
    ResNet units ``int8_site`` admits on the int8 kernel."""
    t = cfg.text_encoder
    kept = min(int(steps * strength), steps)
    n_enc = 2 if kept < steps else 1
    text = {"layer_norm": 2 * t.num_hidden_layers + 1}
    unet, enc, dec = _models(cfg, int8_hw, cfg.unet)
    cached = unet_launches(cfg.unet, encoder=False)
    if int8_hw is not None:
        h, w = _hw(int8_hw)
        cached = int8_split(cached, unet_sites(cfg.unet, h // 8, w // 8,
                                               encoder=False))
    n = evaluations(cfg, scheduler, steps, strength)
    keys = key_steps(n, encoder_cache_interval)
    return _total((keys, unet), (n - keys, cached),
                  (int(text_encoder), text), (n_enc, enc), (1, dec))


def expected_launches_v2(cfg, steps: int, int8_hw=None,
                         scheduler: str = "unipc",
                         task_tower: bool = True,
                         branch_cache_interval: int = 1) -> dict:
    """One ppt-v2 ``__call__``: per sampler iteration one base-UNet
    evaluation and one BrushNet evaluation (guess mode and gated steps run
    the branch all the same; with a ``branch_cache_interval`` above 1, on
    key steps only), the two text towers (the plain one alone when
    ``task_tower`` is False: both embeddings given), one VAE encode and
    one decode."""
    t = cfg.text_encoder
    text = {"layer_norm": 2 * t.num_hidden_layers + 1}
    unet, branch, enc, dec = _models(cfg, int8_hw, cfg.unet, cfg.brushnet.base)
    n = evaluations(cfg, scheduler, steps)
    return _total((n, unet), (key_steps(n, branch_cache_interval), branch),
                  (1 + int(task_tower), text), (1, enc), (1, dec))


def expected_launches_cn(cfg, steps: int, branches: int = 1,
                         int8_hw=None, scheduler: str = "ddim") -> dict:
    """One ppt-v1 + ControlNet ``__call__`` with a control image: the ppt-v1
    call's launches, and per sampler iteration one evaluation of each
    branch (guess mode and gated steps run the branches all the same)."""
    u = cfg.controlnet.base
    branch = controlnet_launches(u)
    if int8_hw is not None:
        h, w = _hw(int8_hw)
        branch = int8_split(branch, unet_sites(u, h // 8, w // 8,
                                               encoder_only=True))
    v1 = expected_launches(cfg, steps, int8_hw=int8_hw, scheduler=scheduler)
    return _total((1, v1), (evaluations(cfg, scheduler, steps) * branches,
                            branch))


def counters():
    from powerpaint_tpu_torch.ops import conv, norms
    from powerpaint_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bf16_softmax,
        flash_attention_lse,
    )

    return {"flash_attention": flash_attention,
            "flash_attention_lse": flash_attention_lse,
            "flash_attention_bf16_softmax": flash_attention_bf16_softmax,
            "group_norm_moments": norms.group_norm_moments,
            "group_norm": norms.group_norm,
            "group_norm_stats": norms.group_norm_stats,
            "gn_silu_quantize_int8": norms.gn_silu_quantize_int8,
            "quantize_int8": norms.quantize_int8,
            "layer_norm": norms.layer_norm, "conv3x3_gn_silu": conv.conv3x3_gn_silu,
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
        module = getattr(pipe, attr)  # a model, or a ModuleList of branches
        for m in (module if isinstance(module, torch.nn.ModuleList)
                  else [module]):
            m.forward = timed(m.forward, stage)


def inputs(hw, seed: int):
    """A random image of side ``hw`` (or (H, W)) and a centred square
    hole."""
    h, w = _hw(hw)
    rng = np.random.RandomState(seed)
    image = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    mask = np.zeros((h, w), np.float32)
    mask[h // 4:3 * h // 4, w // 4:3 * w // 4] = 1.0
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

    def call(label, at=None, **kw):
        """``at``: another (image, mask) pair for this call."""
        kw.setdefault("num_inference_steps", STEPS)
        kw.setdefault("guidance_scale", GUIDANCE)
        before = read_counts()
        stage_seconds.clear()
        finite.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipe(*(at or (image, mask)), **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        after = read_counts()
        got = {k: after[k] - before[k] for k in after}
        want = expected(kw)
        call.seconds = secs
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

    # warm-up: cuDNN / cuBLAS plans for the
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
    from powerpaint_tpu_torch.ops.conv import int8_site
    from powerpaint_tpu_torch.ops.norms import gn_silu_fp32, group_norm_stats

    stats = {"saturated": 0, "values": 0, "sites": 0}
    active = [True]

    def pre(mod, args, kwargs):
        x, gn = args[0], kwargs.get("gn")
        if not active[0] or gn is None or \
                not int8_site(*x.shape[1:], mod.out_channels):
            return
        n = group_norm_stats.launches  # the hook's own launch is not the call's
        y = gn_silu_fp32(x.contiguous(), gn.weight, gn.bias,
                         num_groups=gn.num_groups, eps=gn.eps)
        group_norm_stats.launches = n
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


def edge_map(hw: int, seed: int) -> np.ndarray:
    """A drawn canny-like control image: white 1-pixel outlines of a few
    boxes and rings on black, (hw, hw, 3) uint8."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:hw, :hw]
    edges = np.zeros((hw, hw), bool)
    for _ in range(4):
        y0, x0 = rng.randint(0, hw // 2, 2)
        y1, x1 = y0 + rng.randint(hw // 8, hw // 2, 2)
        edges[y0:y1, x0] = edges[y0:y1, x1 - 1] = True
        edges[y0, x0:x1] = edges[y1 - 1, x0:x1] = True
        cy, cx = rng.randint(hw // 4, 3 * hw // 4, 2)
        edges |= np.abs(np.hypot(yy - cy, xx - cx) - rng.randint(8, hw // 4)) < 0.7
    return np.repeat(edges[..., None], 3, -1).astype(np.uint8) * 255


def run_cn_path(device, v1_refs: dict):
    """ppt-v1 + ControlNet at full width, 20 DDIM steps, a drawn edge map:
    the four tasks, a repeat, another seed, no control image (bitwise the
    ppt-v1 path's image ``v1_refs``), guess mode, control_guidance_end 0.5,
    two branches, a two-request batch; then one call with int8 on."""
    import os

    from powerpaint_tpu_torch.core.config import ppt_v1_controlnet_config
    from powerpaint_tpu_torch.io.weights import (
        build_models,
        init_state,
        random_state,
    )
    from powerpaint_tpu_torch.pipelines.controlnet import ControlNetPipeline

    cfg = ppt_v1_controlnet_config()
    t0 = time.perf_counter()
    state = init_state(cfg, torch.Generator(device=device).manual_seed(0),
                       device=device, dtype=torch.bfloat16)
    pipe = ControlNetPipeline(cfg, state, _tokenizer(cfg), dtype=torch.bfloat16,
                              device=device)
    # a second branch (seed 1) beside the first, for the two-branch call
    second = random_state(build_models(cfg)["controlnet"],
                          torch.Generator(device=device).manual_seed(1),
                          device=device, dtype=torch.bfloat16)
    pipe2 = ControlNetPipeline(
        cfg, dict(state, controlnet=[state["controlnet"], second]),
        _tokenizer(cfg), dtype=torch.bfloat16, device=device)
    del state, second
    count = lambda *ms: sum(p.numel() for m in ms for p in m.parameters())  # noqa: E731
    log(phase="setup", path="ppt-v1 + controlnet",
        params=count(pipe.unet, pipe.vae, pipe.text_encoder, pipe.controlnet),
        unet_params=count(pipe.unet), controlnet_params=count(pipe.controlnet),
        seconds=time.perf_counter() - t0)

    image, mask = inputs(HW, 0)
    edges, edges2 = edge_map(HW, 0), edge_map(HW, 1)

    def expected(branches):
        def want(kw):
            if kw.get("control_image") is None:
                return expected_launches(cfg, kw["num_inference_steps"])
            return expected_launches_cn(cfg, kw["num_inference_steps"], branches)
        return want

    stages = (("controlnet", "denoise_controlnet"), ("unet", "denoise_base_unet"))
    call = _caller(pipe, image, mask, expected(1), models=stages)
    call2 = _caller(pipe2, image, mask, expected(2), models=stages)
    prompt = "a red bench in a park"
    call("cn warm-up", prompt="a cat", control_image=edges, seed=99)

    reset_counts()  # the path starts here
    outs = {}
    for task in TASKS:
        outs[task] = call(f"cn {task}", prompt=prompt, task=task, seed=1,
                          control_image=edges)
        check(outs[task].shape == (1, HW, HW, 3) and outs[task].dtype == np.uint8,
              f"cn {task}: output {outs[task].shape} {outs[task].dtype}")
    base = outs["text-guided"]
    again = call("cn text-guided same seed", prompt=prompt, seed=1,
                 control_image=edges)
    check(np.array_equal(again, base), "cn: the same seed gave a different image")
    other = call("cn text-guided other seed", prompt=prompt, seed=2,
                 control_image=edges)
    check(not np.array_equal(other, base), "cn: another seed gave the same image")
    plain = call("cn no control image", prompt=prompt, seed=1)
    check(np.array_equal(plain, v1_refs["text-guided"]),
          "cn: control_image=None is not the ppt-v1 pipeline's image")
    check(not np.array_equal(base, plain),
          "cn: the control image did not change the image (dead branch)")
    for label, kw in (("cn guess mode", dict(guess_mode=True)),
                      ("cn control_guidance_end 0.5",
                       dict(control_guidance_end=0.5))):
        out = call(label, prompt=prompt, seed=1, control_image=edges, **kw)
        d = np.abs(out.astype(np.int32) - base.astype(np.int32))
        log(call=label, vs_plain_cn_max_uint8_diff=int(d.max()),
            vs_plain_cn_mean_uint8_diff=float(d.mean()))
        check(d.max() > 0, f"{label}: the image did not change")
    two = call2("cn two branches", prompt=prompt, seed=1,
                control_image=[edges, edges2],
                controlnet_conditioning_scale=[1.0, 0.8])
    d = np.abs(two.astype(np.int32) - base.astype(np.int32))
    log(call="cn two branches", vs_one_branch_max_uint8_diff=int(d.max()),
        vs_one_branch_mean_uint8_diff=float(d.mean()))
    check(d.max() > 0, "cn two branches: the second branch changed nothing")
    batch = call("cn batch of two", prompt=[prompt, "a dog"],
                 negative_prompt=["", "blurry"], fitting_degree=[1.0, 0.5],
                 control_image=[edges, edges2], seed=[1, 5])
    check(batch.shape == (2, HW, HW, 3), f"cn batch output {batch.shape}")
    d = np.abs(batch[0].astype(np.int32) - base[0].astype(np.int32))
    log(path="ppt-v1 + controlnet", batch_vs_standalone_max_uint8_diff=int(d.max()),
        batch_vs_standalone_mean_uint8_diff=float(d.mean()))
    launches = _path_counts("ppt-v1 + controlnet", expected_launches_cn(cfg, STEPS))
    profile_call("ppt-v1 + controlnet", lambda: pipe(
        image, mask, edges, prompt=prompt, seed=1, num_inference_steps=STEPS,
        guidance_scale=GUIDANCE))
    del pipe, pipe2
    torch.cuda.empty_cache()

    # int8 on, read by the pipeline from the environment
    os.environ["POWERPAINT_INT8"] = "1"
    os.environ.pop("POWERPAINT_INT8_XSCALE", None)
    t0 = time.perf_counter()
    state = init_state(cfg, torch.Generator(device=device).manual_seed(0),
                       device=device, dtype=torch.bfloat16)
    pipe = ControlNetPipeline(cfg, state, _tokenizer(cfg), dtype=torch.bfloat16,
                              device=device)
    del state
    check(pipe.int8_x_scale == 8.0 / 127.0, f"cn int8: x_scale {pipe.int8_x_scale}")
    log(phase="setup", path="ppt-v1 + controlnet int8", x_scale=pipe.int8_x_scale,
        seconds=time.perf_counter() - t0)
    call = _caller(pipe, image, mask, lambda kw: expected_launches_cn(
        cfg, kw["num_inference_steps"], int8_hw=HW))
    sat = saturation_share(pipe, (pipe.controlnet, pipe.unet), lambda: call(
        "cn int8 warm-up (saturation hooks)", prompt=prompt, seed=1,
        control_image=edges))
    log(path="ppt-v1 + controlnet int8", saturation=sat)
    reset_counts()  # the int8 call starts here
    out = call("cn int8 text-guided", prompt=prompt, seed=1, control_image=edges)
    log(path="ppt-v1 + controlnet int8", task="text-guided",
        psnr_vs_bf16=psnr(out, base))
    int8_launches = _path_counts("ppt-v1 + controlnet int8",
                                 expected_launches_cn(cfg, STEPS, int8_hw=HW))
    os.environ.pop("POWERPAINT_INT8")
    return {k: launches[k] + int8_launches[k] for k in launches}


def denoise_device_ms(pipe, run):
    """Run ``run()`` (one pipeline call) with its denoise loop alone under
    ``torch.profiler``: the device time in ms of the kernels the loop
    launched, the sampler's steps included, or None when the profiler
    records no device time."""
    from torch.profiler import ProfilerActivity, profile

    inner, box = pipe._denoise, {}

    def profiled(*args, **kw):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = inner(*args, **kw)
            torch.cuda.synchronize()
        box["us"] = sum(e.self_device_time_total for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA)
        return out

    pipe._denoise = profiled
    try:
        run()
    finally:
        pipe._denoise = inner
    return box["us"] / 1e3 if box.get("us") else None


# The widest batch-vs-alone difference of a ppt-v1 image Queue C records
# (its int8 entry): cuBLAS's fp32 K/V projections and cuDNN's stride-2
# downsample are batch-variant, and the bf16 entry (max 10, mean 1.19) is
# no bound: the 20-step DDIM batch itself measures 11 / 1.21 in some runs
V1_BATCH_MAX_UINT8, V1_BATCH_MEAN_UINT8 = 18, 2.0
# phase 7c's steps (heun's ControlNet call keeps STEPS): 20 until the
# training phase came, cut to 5 to keep the script inside its time; the
# device ms per evaluation it measures does not depend on the count
SAMPLER_STEPS = 5


def run_sampler_path(device):
    """Phase 7c: the sampler family at full width, bf16, 512^2, guidance
    7.5. ppt-v1: each registry sampler but DDIM (phase 3's) at
    ``SAMPLER_STEPS`` (LCM at 4), then euler at strength 0.6, euler_a again
    with the same seed (bitwise the same image) and as a two-request batch
    (each image's step noise bitwise its standalone draw; the images within
    Queue C's batch-vs-alone difference). ppt-v2: euler_a on UniPC's
    stack, and an LCM-distilled UNet (``time_cond_proj_dim`` 256, as
    SimianLuo/LCM_Dreamshaper_v7) at 4 LCM steps, where guidance 5 and 9
    must differ. ppt-v1 + ControlNet: heun at 20 steps (39 evaluations of
    the UNet and the branch) with the window [0.1, 0.6]. Every call's
    launches are the sampler's evaluation count's, exactly; each sampler
    logs its seconds per image and its denoise loop's device ms per UNet
    evaluation (a profiled second call)."""
    from powerpaint_tpu_torch import schedulers
    from powerpaint_tpu_torch.core.config import (
        ppt_v1_config,
        ppt_v1_controlnet_config,
        ppt_v2_config,
    )
    from powerpaint_tpu_torch.io.weights import init_state
    from powerpaint_tpu_torch.pipelines.brushnet import BrushNetPipeline
    from powerpaint_tpu_torch.pipelines.controlnet import ControlNetPipeline
    from powerpaint_tpu_torch.pipelines.inpaint import InpaintPipeline

    prompt = "a red bench in a park"
    image, mask = inputs(HW, 0)

    def build(cls, cfg, label):
        t0 = time.perf_counter()
        state = init_state(cfg, torch.Generator(device=device).manual_seed(0),
                           device=device, dtype=torch.bfloat16)
        pipe = cls(cfg, state, _tokenizer(cfg), dtype=torch.bfloat16,
                   device=device)
        log(phase="setup", path=label, seconds=time.perf_counter() - t0)
        return pipe

    def sampled(pipe, call, path, name, steps, **kw):
        """One checked call of sampler ``name``, then the same call with
        its denoise loop profiled."""
        label = f"samplers {path} {name}" + "".join(
            f" {k} {v}" for k, v in kw.items() if k != "control_image")
        kw = dict(prompt=prompt, seed=1, scheduler=name,
                  num_inference_steps=steps, **kw)
        out = call(label, **kw)
        secs = call.seconds
        n = evaluations(pipe.config, name, steps, kw.get("strength", 1.0))
        ms = denoise_device_ms(pipe, lambda: pipe(
            image, mask, **{"guidance_scale": GUIDANCE, **kw}))
        log(sampler=name, path=path, steps=steps, unet_evaluations=n,
            seconds_per_image=secs / out.shape[0], denoise_device_ms=ms,
            device_ms_per_evaluation=(ms / n if ms else "not measured"))
        return out

    def diff(a, b):
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        return int(d.max()), float(d.mean())

    # ---- ppt-v1: every sampler of the registry but DDIM
    cfg = ppt_v1_config()
    pipe = build(InpaintPipeline, cfg, "samplers ppt-v1")
    call = _caller(pipe, image, mask, lambda kw: expected_launches(
        cfg, kw["num_inference_steps"], kw.get("strength", 1.0),
        scheduler=kw.get("scheduler", "ddim")))
    reset_counts()  # the path starts here
    outs = {}
    for name in schedulers.SCHEDULERS:
        if name != "ddim":
            outs[name] = sampled(pipe, call, "ppt-v1", name,
                                 4 if name == "lcm" else SAMPLER_STEPS)
            check(outs[name].shape == (1, HW, HW, 3),
                  f"samplers {name}: output {outs[name].shape}")
    check(len({o.tobytes() for o in outs.values()}) == len(outs),
          "samplers: two samplers gave the same image")
    sampled(pipe, call, "ppt-v1", "euler", SAMPLER_STEPS, strength=0.6)

    draws = []
    draw = pipe._draw_noise
    pipe._draw_noise = lambda *a: draws.append(draw(*a)) or draws[-1]
    kw = dict(scheduler="euler_a", num_inference_steps=SAMPLER_STEPS)
    again = call("samplers v1 euler_a same seed", prompt=prompt, seed=1, **kw)
    both = call("samplers v1 euler_a batch of two", prompt=[prompt, "a dog"],
                seed=[1, 5], **kw)
    alone = call("samplers v1 euler_a second request alone", prompt="a dog",
                 seed=5, **kw)
    pipe._draw_noise = draw
    check(np.array_equal(again, outs["euler_a"]),
          "euler_a: the same seed gave a different image")
    step_a, step_both, step_alone = (d[3] for d in draws)
    check(len(step_a) == len(step_both) == len(step_alone) == SAMPLER_STEPS,
          f"euler_a: {len(step_both)} step draws for {SAMPLER_STEPS} iterations")
    check(all(torch.equal(x[0:1], y) and torch.equal(x[1:2], z)
              for x, y, z in zip(step_both, step_a, step_alone)),
          "euler_a: a batched request's step noise is not its requests' own")
    for k, ref in ((0, again), (1, alone)):
        mx, mean = diff(both[k], ref[0])
        log(path="samplers ppt-v1", sampler="euler_a", request=k,
            batch_vs_standalone_max_uint8_diff=mx,
            batch_vs_standalone_mean_uint8_diff=mean)
        check(mx <= V1_BATCH_MAX_UINT8 and mean <= V1_BATCH_MEAN_UINT8,
              f"euler_a batch request {k}: max {mx} mean {mean} beyond "
              f"Queue C's {V1_BATCH_MAX_UINT8} / {V1_BATCH_MEAN_UINT8}")
    del pipe
    torch.cuda.empty_cache()

    # ---- ppt-v2: euler_a on UniPC's stack, LCM on an LCM-distilled UNet
    v2_stages = (("brushnet", "denoise_brushnet"), ("unet", "denoise_base_unet"))
    for cfg2, label in (
            (ppt_v2_config(), "ppt-v2"),
            (ppt_v2_config().replace(unet=ppt_v2_config().unet.replace(
                time_cond_proj_dim=256)), "ppt-v2 lcm unet")):
        pipe = build(BrushNetPipeline, cfg2, f"samplers {label}")
        call = _caller(pipe, image, mask, lambda kw, c=cfg2: expected_launches_v2(
            c, kw["num_inference_steps"], scheduler=kw.get("scheduler", "unipc")),
            models=v2_stages)
        if label == "ppt-v2":
            sampled(pipe, call, label, "euler_a", SAMPLER_STEPS)
        else:
            check(pipe.unet.time_embedding.cond_proj is not None,
                  "ppt-v2 lcm unet: no cond_proj")
            g5 = sampled(pipe, call, label, "lcm", 4, guidance_scale=5.0)
            g9 = call("samplers ppt-v2 lcm guidance 9", prompt=prompt, seed=1,
                      scheduler="lcm", num_inference_steps=4, guidance_scale=9.0)
            mx, mean = diff(g9, g5)
            log(path="samplers ppt-v2 lcm unet", guidance_9_vs_5_max_uint8_diff=mx,
                guidance_9_vs_5_mean_uint8_diff=mean)
            check(mx > 0, "LCM: guidance 5 and 9 gave the same image")
        del pipe
        torch.cuda.empty_cache()

    # ---- ppt-v1 + ControlNet: heun, two evaluations a step, a window
    cfg3 = ppt_v1_controlnet_config()
    pipe = build(ControlNetPipeline, cfg3, "samplers ppt-v1 + controlnet")
    call = _caller(pipe, image, mask, lambda kw: expected_launches_cn(
        cfg3, kw["num_inference_steps"], scheduler=kw.get("scheduler", "ddim")),
        models=(("controlnet", "denoise_controlnet"),
                ("unet", "denoise_base_unet")))
    check(evaluations(cfg3, "heun", STEPS) == 2 * STEPS - 1,
          "heun: not 2S-1 evaluations")
    sampled(pipe, call, "ppt-v1 + controlnet", "heun", STEPS,
            control_image=edge_map(HW, 0), control_guidance_start=0.1,
            control_guidance_end=0.6)
    del pipe
    return _path_counts("samplers", expected_launches(cfg, STEPS))


def _window(label: str, want: dict, run):
    """Run ``run()`` synchronised with the launch counts at 0 before it:
    (its result, seconds, launches), which must be ``want`` exactly (the
    kernels not named: none)."""
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = read_counts()
    want = {k: want.get(k, 0) for k in KERNELS}
    check(got == want, f"{label}: launches {got}, expected {want}")
    return out, secs, got


def run_annotator_path(device):
    """Phase 7b: the control maps, the ControlNet annotators and the safety
    checker at full published width, random fp32 weights from seeds,
    through the entry points, with no OpenCV: DPT-hybrid depth (384^2 in,
    1024^2 out) and HED (512^2, its bucket's size) each through
    ``PowerPaint.infer(control_type=...)`` on the full-width ppt-v1 +
    ControlNet stack at 20 DDIM steps; canny (host numpy, 512^2 and 1024^2
    maps) through infer at 512^2 and at ``OFF_BUCKET``; HED at
    ``OFF_BUCKET`` (resized to its bucket and back on the card), plain and
    scribble, through infer; pose through ``OpenposeBodyPreprocessor``
    (its resizes on the card, decode and drawing on the host) and infer;
    the CLIP ViT-L/14 safety checker registered for the ppt-v1 call, then
    one with every concept threshold at -1, which must flag the image and
    black it out. Each window's launches are exact. Then each map's steps on
    the card against the same functions on the CPU, bitwise
    (``control_map_checks``), and each network on the card against the
    same network on the CPU, fp32, at a reduced input, with TF32 off and at
    the default precision."""
    from powerpaint_tpu_torch.controller import PowerPaint
    from powerpaint_tpu_torch.core import config as cfgs
    from powerpaint_tpu_torch.core import safety
    from powerpaint_tpu_torch.io.weights import (
        init_state,
        load_annotator,
        random_annotator_state,
    )
    from powerpaint_tpu_torch.models.dpt import gn_shapes
    from powerpaint_tpu_torch.pipelines.controlnet import ControlNetPipeline
    from powerpaint_tpu_torch.tasks import control, pose

    # PyTorch's default precision, at which the annotators run: cuDNN
    # convolutions in TF32, matmuls in fp32
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cfgs.ppt_v1_controlnet_config()
    dpt_cfg, clip_cfg = cfgs.dpt_hybrid_midas_config(), cfgs.safety_checker_config()
    t0 = time.perf_counter()
    state = init_state(cfg, torch.Generator(device=device).manual_seed(0),
                       device=device, dtype=torch.bfloat16)
    # the ControlNet pipeline without a control image is the ppt-v1 pipeline
    # (bitwise, phase 7), so it serves both of the controller's roles
    pipe = ControlNetPipeline(cfg, state, _tokenizer(cfg), dtype=torch.bfloat16,
                              device=device)
    del state
    pp = PowerPaint(pipe, controlnet_pipeline=pipe)

    def annotator_state(family, seed, config=None):
        return random_annotator_state(
            family, torch.Generator(device=device).manual_seed(seed),
            device=device, config=config)

    states = {"dpt": annotator_state("dpt", 10, dpt_cfg),
              "hed": annotator_state("hed", 11),
              "bodypose": annotator_state("bodypose", 12),
              "safety_checker": annotator_state("safety_checker", 13, clip_cfg)}
    counts = lambda st: sum(v.numel() for v in st.values())  # noqa: E731
    log(phase="setup", path="annotators + safety",
        params={k: counts(v) for k, v in states.items()},
        seconds=time.perf_counter() - t0)
    image, mask = inputs(HW, 0)
    kw = dict(prompt="a red bench in a park", seed=1, num_inference_steps=STEPS,
              guidance_scale=GUIDANCE)
    cn_call = expected_launches_cn(cfg, STEPS)
    total = {k: 0 for k in KERNELS}

    def add(launches):
        for k, n in launches.items():
            total[k] += n

    # ---- depth: 52 GroupNorm launches a map at the hybrid-midas config
    depth = control.register_dpt_depth(state=states["dpt"], config=dpt_cfg,
                                       device=device)
    n_gn = len(gn_shapes(dpt_cfg, dpt_cfg.image_size, dpt_cfg.image_size))
    depth(image)  # warm-up: cuDNN's plans
    dmap, secs, got = _window("depth map", {"group_norm": n_gn},
                              lambda: depth(image))
    add(got)
    check(dmap.shape == (1024, 1024, 3) and dmap.dtype == np.uint8,
          f"depth map {dmap.shape} {dmap.dtype}")
    check(int(dmap.min()) == 0 and int(dmap.max()) == 255,
          f"depth map spans {dmap.min()}..{dmap.max()}, not 0..255")
    log(path="annotators", control="depth", map_seconds=secs,
        group_norm_launches=got["group_norm"], expected=n_gn, shape=list(dmap.shape))
    profile_call("depth map", lambda: depth(image))
    want = dict(cn_call, group_norm=cn_call["group_norm"] + n_gn)
    res, secs, got = _window("infer depth", want, lambda: pp.infer(
        image, mask, control_type="depth", **kw))
    add(got)
    check(res.result.shape == (HW, HW, 3), f"depth infer {res.result.shape}")
    log(call="infer control_type=depth", seconds=secs, seconds_per_image=secs,
        launches=got)

    # ---- HED at 512^2: its bucket's size, so no resize
    hed = control.register_hed(state=states["hed"], device=device)
    control.get_control_image("hed", image)  # warm-up
    emap, secs, got = _window("hed map", {}, lambda: control.get_control_image(
        "hed", image))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hed.edges(image)
    torch.cuda.synchronize()
    net_secs = time.perf_counter() - t0
    check(emap.shape == (HW, HW, 3) and emap.dtype == np.uint8 and emap.std() > 0,
          f"hed map {emap.shape} {emap.dtype} std {emap.std()}")
    log(path="annotators", control="hed", map_seconds=secs, network_seconds=net_secs,
        edge_mean=float(emap.mean()))
    res, secs, got = _window("infer hed", cn_call, lambda: pp.infer(
        image, mask, control_type="hed", **kw))
    add(got)
    log(call="infer control_type=hed", seconds=secs, seconds_per_image=secs,
        launches=got)

    # ---- canny: the host function (numpy and scipy) at 512^2 and 1024^2,
    # then through infer at 512^2 and at OFF_BUCKET (512 x 600: HED's
    # 64-pixel bucket for it is 512 x 576)
    off_image, off_mask = inputs(OFF_BUCKET, 3)
    for side in (HW, 2 * HW):
        img_c = inputs(side, 4)[0]
        control.get_control_image("canny", img_c)  # warm-up: scipy's import
        t0 = time.perf_counter()
        cmap = control.get_control_image("canny", img_c)
        secs = time.perf_counter() - t0
        check(cmap.shape == (side, side, 3) and cmap.dtype == np.uint8
              and cmap.any() and set(np.unique(cmap)) <= {0, 255},
              f"canny map {cmap.shape} {cmap.dtype}")
        log(path="annotators", control="canny", input=[side, side], card=CARD[0],
            map_seconds=secs, edge_share=float((cmap[..., 0] > 0).mean()),
            note="host numpy and scipy")
    for label, img_i, msk_i in (("canny", image, mask), ("canny off-bucket",
                                                          off_image, off_mask)):
        res, secs, got = _window(f"infer {label}", cn_call, lambda: pp.infer(
            img_i, msk_i, control_type="canny", **kw))
        add(got)
        check(res.result.shape == img_i.shape, f"{label} infer {res.result.shape}")
        log(call=f"infer control_type=canny, {img_i.shape[0]}x{img_i.shape[1]}",
            seconds=secs, seconds_per_image=secs, launches=got)

    # ---- HED at OFF_BUCKET: INTER_AREA to the bucket and INTER_LINEAR back
    # on the card, plain and with the scribble pass (NMS, blur)
    check(control._fit_resolution(*OFF_BUCKET, hed.detect_resolution)
          != OFF_BUCKET, f"{OFF_BUCKET} is at its HED bucket's size")
    for scribble in (False, True):
        hed.scribble = scribble
        name = "hed scribble" if scribble else "hed"
        control.get_control_image("hed", off_image)  # warm-up
        emap, secs, got = _window(f"{name} map off-bucket", {},
                                  lambda: control.get_control_image("hed", off_image))
        check(emap.shape == off_image.shape and emap.dtype == np.uint8
              and (scribble or emap.any()), f"{name} map {emap.shape} {emap.dtype}")
        if scribble:  # random weights may leave no edge above the NMS threshold
            check(set(np.unique(emap)) <= {0, 255}, f"scribble map {np.unique(emap)}")
        log(path="annotators", control=name, input=list(OFF_BUCKET),
            bucket=list(control._fit_resolution(*OFF_BUCKET, hed.detect_resolution)),
            card=CARD[0], map_seconds=secs, edge_mean=float(emap.mean()))
        res, secs, got = _window(f"infer {name} off-bucket", cn_call, lambda: pp.infer(
            off_image, off_mask, control_type="hed", **kw))
        add(got)
        check(res.result.shape == off_image.shape, f"{name} infer {res.result.shape}")
        log(call=f"infer control_type=hed, scribble={scribble}, "
            f"{OFF_BUCKET[0]}x{OFF_BUCKET[1]}", seconds=secs,
            seconds_per_image=secs, launches=got)
    hed.scribble = False

    # ---- pose through OpenposeBodyPreprocessor.__call__: the network input's
    # bicubic resize and the fields' upsamples on the card, the decode and
    # the drawing on the host
    body = control.register_openpose(state=states["bodypose"], device=device)
    (h, w), (hp, wp) = pose.network_shape(HW, HW)
    x, scaled_hw = body.network_tensor(image)
    check(tuple(x.shape) == (1, hp, wp, 3) and scaled_hw == (h, w),
          f"pose input {tuple(x.shape)} {scaled_hw}")
    body.fields(x)  # warm-up
    (paf, heat), net_secs, got = _window("pose network", {}, lambda: body.fields(x))
    check(tuple(paf.shape) == (hp // 8, wp // 8, 38)
          and tuple(heat.shape) == (hp // 8, wp // 8, 19)
          and bool(torch.isfinite(paf).all()) and bool(torch.isfinite(heat).all()),
          f"pose fields {tuple(paf.shape)} {tuple(heat.shape)}")
    control.get_control_image("pose", image)  # warm-up
    pmap, secs, got = _window("pose map", {}, lambda: control.get_control_image(
        "pose", image))
    check(pmap.shape == (HW, HW, 3) and pmap.dtype == np.uint8,
          f"pose map {pmap.shape} {pmap.dtype}")
    t0 = time.perf_counter()
    candidate, subset = pose.decode(paf, heat, scaled_hw, (HW, HW))
    decode_secs = time.perf_counter() - t0
    log(path="annotators", control="pose", network_input=[1, hp, wp, 3], card=CARD[0],
        network_seconds=net_secs, map_seconds=secs, decode_seconds=decode_secs,
        peaks=int(len(candidate)), people=int(len(subset)))
    res, secs, got = _window("infer pose", cn_call, lambda: pp.infer(
        image, mask, control_type="pose", **kw))
    add(got)
    check(res.result.shape == (HW, HW, 3), f"pose infer {res.result.shape}")
    log(call="infer control_type=pose", seconds=secs, seconds_per_image=secs,
        launches=got)
    control_map_checks(device, hed, body, off_image, image, paf, heat, scaled_hw)

    # ---- the safety checker on the ppt-v1 call: 50 LayerNorm launches a
    # check (pre, 24 x 2, post)
    n_ln = 2 * clip_cfg.num_hidden_layers + 2
    checker = safety.CLIPSafetyChecker(clip_cfg, states["safety_checker"],
                                       device=device)
    checker(image[None])  # warm-up
    flags, secs, got = _window("safety check", {"layer_norm": n_ln},
                               lambda: checker(image[None]))
    add(got)
    log(path="safety", check_seconds=secs, layer_norm_launches=got["layer_norm"],
        expected=n_ln, flags=flags)
    profile_call("safety check", lambda: checker(image[None]))
    v1_call = expected_launches(cfg, STEPS)
    want = dict(v1_call, layer_norm=v1_call["layer_norm"] + n_ln)
    safety.register_safety_checker(checker)
    try:
        res, secs, got = _window("infer + safety", want, lambda: pp.infer(
            image, mask, **kw))
        add(got)
        check(res.nsfw_flags == [False] and res.raw.any(),
              f"safety: random thresholds flagged the image ({res.nsfw_flags})")
        log(call="infer + safety checker", seconds=secs, flags=res.nsfw_flags,
            launches=got)
        flag_all = dict(states["safety_checker"],
                        concept_embeds_weights=torch.full_like(
                            states["safety_checker"]["concept_embeds_weights"], -1.0))
        safety.register_safety_checker(
            safety.CLIPSafetyChecker(clip_cfg, flag_all, device=device))
        res, secs, got = _window("infer + flagging checker", want,
                                 lambda: pp.infer(image, mask, **kw))
        add(got)
        check(res.nsfw_flags == [True] and not res.raw.any(),
              f"safety: thresholds of -1 gave flags {res.nsfw_flags}, "
              f"raw max {res.raw.max()}")
        log(call="infer + flagging checker", seconds=secs, flags=res.nsfw_flags,
            raw_max=int(res.raw.max()))
    finally:
        safety.register_safety_checker(None)
        for kind in ("depth", "hed", "pose"):
            control._REGISTRY.pop(kind, None)

    # ---- each network on the card against the CPU in fp32, at a reduced
    # input. With TF32 off the two sides run the same fp32 operations in
    # another order, which moves an output by a few ulps per layer: bound
    # 1e-3 of the CPU output's largest magnitude. At PyTorch's default
    # precision (cuDNN convolutions in TF32, as the annotators run) the
    # products keep 10 of fp32's 23 mantissa bits: bound 0.1, against gross
    # faults only (at full size the measured differences are in PERF.md).
    rng = np.random.RandomState(5)
    cases = (("dpt", dpt_cfg, rng.rand(1, 128, 96, 3) * 2 - 1, lambda m, x: m(x)),
             ("hed", None, rng.rand(1, 64, 96, 3), lambda m, x: m(x)),
             ("bodypose", None, rng.rand(1, 64, 96, 3) - 0.5,
              lambda m, x: torch.cat([f.flatten() for f in m(x)])),
             ("safety_checker", clip_cfg,
              rng.randn(1, clip_cfg.image_size, clip_cfg.image_size, 3),
              lambda m, x: m.visual_projection(m.vision_model(x)[1])))
    for family, config, x, fwd in cases:
        x = torch.as_tensor(x.astype(np.float32))

        def run(dev):
            st = {k: v.to(dev) for k, v in states[family].items()}
            with torch.no_grad():
                return fwd(load_annotator(family, st, config=config, device=dev),
                           x.to(dev)).float().cpu()

        ref = run(torch.device("cpu"))
        errs = {}
        for name, cudnn_tf32 in (("exact", False), ("tf32", True)):
            torch.backends.cudnn.allow_tf32 = cudnn_tf32
            errs[name] = float((run(device) - ref).abs().max())
        scale = float(ref.abs().max())
        log(card_vs_cpu=family, input=list(x.shape), max_abs_ref=scale,
            max_abs_err_tf32_off=errs["exact"], bound_tf32_off=1e-3 * scale,
            max_abs_err_default=errs["tf32"], bound_default=0.1 * scale)
        check(errs["exact"] <= 1e-3 * scale and errs["tf32"] <= 0.1 * scale,
              f"{family}: card vs CPU {errs} beyond {1e-3 * scale} (TF32 off) "
              f"or {0.1 * scale} (default)")
    del pipe, pp
    return total


def control_map_checks(device, hed, body, off_image, image, paf, heat,
                       scaled_hw) -> None:
    """The control maps' steps on the card against the same port functions
    on the CPU, on the same inputs, bitwise: HED's resize to its bucket
    (INTER_AREA), then from the card's edge probability its safe steps,
    INTER_LINEAR back and scribble pass (fp32 blur with its fused
    multiply-adds, dilations, uint8 blur); pose's network input (uint8
    INTER_CUBIC) and its fields' two fp32 INTER_CUBIC upsamples. canny and
    the skeleton's drawing run on the host: a seeded skeleton is drawn and
    timed."""
    from powerpaint_tpu_torch.tasks import control, pose

    cpu = torch.device("cpu")
    hed_cpu = control.HEDPreprocessor(
        state={k: v.to(cpu) for k, v in hed.model.state_dict().items()},
        detect_resolution=hed.detect_resolution, device=cpu)
    x_dev = hed.network_input(off_image)
    x_cpu = hed_cpu.network_input(off_image)
    check(x_dev.shape == x_cpu.shape and torch.equal(x_dev.cpu(), x_cpu),
          "hed: the resize to the bucket differs between the card and the CPU")
    prob = hed.probability(x_dev)
    # the random network's probabilities (too faint for the scribble pass to
    # keep an edge), and seeded ridges at the same size, which it keeps
    bh, bw = prob.shape
    v, u = np.mgrid[:bh, :bw] / np.array([bh, bw], np.float64)[:, None, None]
    ridges = np.exp(-(((np.sin(u * 6.0) * 0.1 + v % 0.5 - 0.25) / 0.06) ** 2))
    ridges = torch.as_tensor(ridges.astype(np.float32), device=device)
    for source, p in (("network", prob), ("ridges", ridges)):
        for safe, scribble in ((False, False), (True, False), (False, True)):
            hed.safe = hed_cpu.safe = safe
            hed.scribble = hed_cpu.scribble = scribble
            got = hed.finish(p, off_image.shape[:2]).cpu()
            want = hed_cpu.finish(p.cpu(), off_image.shape[:2])
            diff = int((got != want).sum())
            log(card_vs_cpu="hed map steps", probability=source, safe=safe,
                scribble=scribble, shape=list(got.shape), pixels_differing=diff,
                lit_share=float((want > 0).float().mean()))
            check(diff == 0, f"hed {source} safe={safe} scribble={scribble}: "
                  f"{diff} pixels differ between the card and the CPU")
            check(source == "network" or bool(want.any()),
                  f"hed ridges scribble={scribble}: an empty map")
    hed.safe = hed.scribble = False
    x_dev, hw_dev = pose.network_tensor(image, device)
    x_cpu, hw_cpu = pose.network_tensor(image, cpu)
    check(hw_dev == hw_cpu == scaled_hw and torch.equal(x_dev.cpu(), x_cpu),
          "pose: the network input differs between the card and the CPU")
    hw = image.shape[:2]
    on_card = pose.upsample_fields(paf, heat, scaled_hw, hw)
    on_cpu = pose.upsample_fields(paf.cpu(), heat.cpu(), scaled_hw, hw)
    for name, a, b in zip(("paf", "heat"), on_card, on_cpu):
        diff = int((a != b).sum())
        log(card_vs_cpu=f"pose {name} upsample", shape=list(a.shape),
            elements_differing=diff)
        check(diff == 0, f"pose {name}: {diff} elements differ between the "
              "card and the CPU")
    rng = np.random.RandomState(6)
    people = []
    for _ in range(3):
        row = -np.ones(20)
        row[:18] = np.arange(18) + 18 * len(people)
        people.append(row)
    cand = np.concatenate([np.stack([rng.uniform(-0.2, 1.2, 18) * hw[1],
                                     rng.uniform(-0.2, 1.2, 18) * hw[0],
                                     rng.rand(18), np.arange(18) + 18 * i], 1)
                           for i in range(3)])
    t0 = time.perf_counter()
    skeleton = pose.draw_bodypose(hw[0], hw[1], cand, np.stack(people))
    log(path="annotators", control="pose drawing", people=3, card=CARD[0],
        seconds=time.perf_counter() - t0, lit_share=float((skeleton > 0).mean()))
    check(skeleton.any(), "pose: the seeded skeleton drew nothing")
    del hed_cpu


def kernel_resources(nvcc_logs: dict) -> None:
    """Each compiled kernel's registers, static shared memory and spills
    (``nvcc -Xptxas -v``) and ptxas's performance warnings, the GroupNorm
    kernel's form and cluster size and the LayerNorm kernel's cut of a row
    (``ln_plan``) at each checked shape, and, where
    ``cuobjdump`` exists, the count of wgmma instructions in its SASS by
    mnemonic (HGMMA for bf16, IGMMA for int8) and of MUFU.EX2 by its full
    mnemonic (the bf16 form, MUFU.EX2.BF16, apart). The conv and attention kernels' dynamic shared memory is in their
    kernel lines (``smem_bytes``)."""
    import re
    import shutil

    from powerpaint_tpu_torch.ops import _build

    for name, text in nvcc_logs.items():
        entry = None
        for line in text.splitlines():
            if "Potential Performance Loss" in line:  # e.g. wgmma serialised
                log(nvcc=name, ptxas_warning=line.strip())
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = m.group(1)
                props = {}
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m and entry:
                props.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m and entry:
                smem = re.search(r"(\d+) bytes smem", line)
                log(nvcc=name, kernel=entry, registers=int(m.group(1)),
                    static_smem=int(smem.group(1)) if smem else 0, **props)
                entry = None
    # group_norm.cu's cluster size and form at each GroupNorm shape checked,
    # layer_norm.cu's cut of a row at each LayerNorm shape
    from powerpaint_tpu_torch.ops.norms import gn_plan, ln_plan

    for shape, _, _ in GN_SHAPES:
        for esize, dtype in ((4, "float32"), (2, "bfloat16")):
            p = gn_plan(shape[1], shape[2], 32, esize, sms=SM_COUNT[0])
            log(nvcc="group_norm", shape=list(shape), dtype=dtype,
                form="resident" if p["resident"] else "streamed",
                cluster=p["cluster"], span=p["span"], rows=p["rows"],
                smem_bytes=p["smem"])
    for shape, _ in LN_SHAPES + [LN_RAGGED]:
        for esize, dtype in ((4, "float32"), (2, "bfloat16")):
            log(nvcc="layer_norm", shape=list(shape), dtype=dtype,
                **ln_plan(shape[-1], esize))
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for name in _build.SOURCES:
        try:
            sass = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                                  capture_output=True, text=True, check=True).stdout
        except (OSError, subprocess.CalledProcessError) as e:
            log(cuobjdump=name, result=f"not measured: {e}")
            continue
        counts, ex2, fn = {}, {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                counts[fn] = {}
                continue
            m = re.search(r"\b([HIQ]GMMA)\.", line)  # bf16 / int8 / fp8 wgmma
            if fn is not None and m:
                counts[fn][m.group(1)] = counts[fn].get(m.group(1), 0) + 1
            m = re.search(r"\b(MUFU\.EX2\S*)", line)  # with its type suffix
            if fn is not None and m:
                mn = m.group(1).rstrip(",;")
                ex2.setdefault(fn, {})[mn] = ex2.get(fn, {}).get(mn, 0) + 1
        log(cuobjdump=name, gmma_per_kernel=counts)
        if ex2:  # static counts in each kernel's code
            log(cuobjdump=name, mufu_ex2_per_kernel=ex2)


# ---------------------------------------------------------------------------
# phase 7d: checkpoints, LoRA and textual inversion
# ---------------------------------------------------------------------------


def _fp16_state(cfg, device) -> dict:
    """``init_state`` (seed 0) with every float tensor in fp16: the weights
    a checkpoint in fp16 holds."""
    from powerpaint_tpu_torch.io.weights import init_state

    state = init_state(cfg, torch.Generator(device=device).manual_seed(0),
                       device=device, dtype=torch.float16)
    return {f: {k: v.half() if v.is_floating_point() else v
                for k, v in sd.items()} for f, sd in state.items()}


def _with_position_ids(sd: dict) -> dict:
    """A transformers CLIP state dict carries its ``position_ids`` buffer."""
    return {**sd, "text_model.embeddings.position_ids": torch.arange(77)[None]}


def _write(path: str, sd: dict) -> int:
    """``sd`` to ``path`` (safetensors with the port's writer, or a torch
    pickle for ``.bin``); returns the file's bytes."""
    import os

    from powerpaint_tpu_torch.io.safetensors import save_file

    os.makedirs(os.path.dirname(path), exist_ok=True)
    if path.endswith(".bin"):
        torch.save({k: v.cpu() for k, v in sd.items()}, path)
    else:
        save_file(sd, path)
    return os.path.getsize(path)


def _read_seconds(paths) -> float:
    """Seconds to read the files into CPU state dicts again (the page cache
    warm, as for the load just timed): the loader's host share."""
    from powerpaint_tpu_torch.io.convert import load_state_dict

    t0 = time.perf_counter()
    for path in paths:
        load_state_dict(path)
    return time.perf_counter() - t0


def _same_weights(label: str, got, want) -> None:
    """Every tensor of ``got``'s state dict bitwise ``want``'s."""
    a, b = got.state_dict(), want.state_dict()
    check(a.keys() == b.keys(), f"{label}: state-dict names differ")
    bad = [k for k in a if a[k].dtype != b[k].dtype or not torch.equal(a[k], b[k])]
    check(not bad, f"{label}: {len(bad)} tensors differ from the in-memory "
                   f"pipeline's, e.g. {bad[:3]}")


def kohya_lora(pipe, rank: int = 8, alpha: float = 4.0, seed: int = 0) -> dict:
    """A kohya-format LoRA over every UNet attention and feed-forward
    projection, every CLIP self-attention projection, and a LoCon on every
    ResNet unit's conv1 / conv2, fp16, from a seed."""
    import re

    g = torch.Generator().manual_seed(seed)
    unet = re.compile(r".*(attn[12]\.(to_[qkv]|to_out\.0)|ff\.net\.(0\.proj|2)"
                      r"|resnets\.\d+\.conv[12])$")
    clip = re.compile(r".*self_attn\.(q|k|v|out)_proj$")
    sd = {}
    for prefix, model, pattern in (("lora_unet_", pipe.unet, unet),
                                   ("lora_te_", pipe.text_encoder, clip)):
        for name, m in model.named_modules():
            if not pattern.fullmatch(name):
                continue
            w = m.weight
            key = prefix + name.replace(".", "_")
            sd[key + ".lora_down.weight"] = (
                torch.randn(rank, *w.shape[1:], generator=g)
                * w[0].numel() ** -0.5).half()
            sd[key + ".lora_up.weight"] = (
                torch.randn(w.shape[0], rank, *([1, 1] if w.ndim == 4 else []),
                            generator=g) * 0.1).half()
            sd[key + ".alpha"] = torch.tensor(alpha)
    return sd


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def run_checkpoint_path(device):
    """Phase 7d: full-width checkpoints written in the reference's layouts
    (fp16, the port's own safetensors writer), loaded through
    ``powerpaint_tpu_torch.load`` on the card, a kohya LoRA (merge,
    per-call scale, unload, on int8 too) and a textual-inversion token."""
    import os
    import shutil

    import powerpaint_tpu_torch
    from powerpaint_tpu_torch.core.config import ppt_v1_config, ppt_v2_config
    from powerpaint_tpu_torch.models.layers import Conv2D
    from powerpaint_tpu_torch.ops import conv
    from powerpaint_tpu_torch.pipelines.brushnet import BrushNetPipeline
    from powerpaint_tpu_torch.pipelines.inpaint import InpaintPipeline

    work = os.path.join("smoke_out", "checkpoints")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    v1_cfg, v2_cfg = ppt_v1_config(), ppt_v2_config()
    from powerpaint_tpu_torch.io.weights import build_models

    need = 2 * sum(p.numel() for m in build_models(v2_cfg).values()
                   for p in m.parameters()) + (1 << 30)
    free = shutil.disk_usage(work).free
    log(phase="checkpoints", disk_free_bytes=free, disk_needed_bytes=need)
    check(free >= need, f"checkpoints: {free} bytes free under {work}, "
                        f"{need} needed")
    image, mask = inputs(HW, 0)
    prompt = "a red bench in a park"
    kw = dict(prompt=prompt, seed=1, num_inference_steps=STEPS,
              guidance_scale=GUIDANCE)

    # 1. a ppt-v1 directory
    root = os.path.join(work, "ppt-v1")
    state = _fp16_state(v1_cfg, device)
    files = {os.path.join(root, *rel): sd for rel, sd in (
        (("unet", "diffusion_pytorch_model.safetensors"), state["unet"]),
        (("text_encoder", "model.safetensors"),
         _with_position_ids(state["text_encoder"])),
        (("vae", "diffusion_pytorch_model.safetensors"), state["vae"]))}
    t0 = time.perf_counter()
    nbytes = sum(_write(path, sd) for path, sd in files.items())
    write_s = time.perf_counter() - t0
    ref = InpaintPipeline(v1_cfg, state, _tokenizer(v1_cfg),
                          dtype=torch.bfloat16, device=device)
    del state
    want = ref(image, mask, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe = powerpaint_tpu_torch.load(root, "ppt-v1").pipeline
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    read_s = _read_seconds(files)
    log(checkpoint="ppt-v1", card=CARD[0], bytes=nbytes, write_seconds=write_s,
        load_seconds=load_s, load_gb_per_s=nbytes / load_s / 1e9,
        read_seconds=read_s, read_gb_per_s=nbytes / read_s / 1e9)
    del files
    check(pipe.unet.conv_in.weight.device.type == device.type,
          "ppt-v1 load: not on the card")
    for f in ("unet", "vae", "text_encoder"):
        _same_weights(f"ppt-v1 load {f}", getattr(pipe, f), getattr(ref, f))
    del ref
    torch.cuda.empty_cache()

    expected = lambda kw: expected_launches(v1_cfg, kw["num_inference_steps"])  # noqa: E731
    call = _caller(pipe, image, mask, expected)
    reset_counts()  # the path starts here
    base = call("ckpt v1 loaded", **kw)
    log(call="ckpt v1 loaded", card=CARD[0], image_seconds=call.seconds)
    check(np.array_equal(base, want),
          "ppt-v1 load: the image is not the in-memory pipeline's")

    # 2. a kohya LoRA on the loaded pipeline
    lora_path = os.path.join(work, "style_lora.safetensors")
    _write(lora_path, kohya_lora(pipe))
    before = {f"{t}.{k}": v.clone() for t in ("unet", "text_encoder")
              for k, v in getattr(pipe, t).state_dict().items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    unmatched = pipe.load_lora_weights(lora_path, scale=0.8)
    torch.cuda.synchronize()
    merge_s = time.perf_counter() - t0
    plan = pipe._loaded_loras[-1][0]
    log(lora="kohya rank 8 alpha 4 scale 0.8", card=CARD[0],
        modules=len(plan.items), merge_seconds=merge_s, unmatched=unmatched)
    check(unmatched == [], f"lora: unmatched {unmatched}")
    styled = call("ckpt v1 lora 0.8", **kw)
    log(call="ckpt v1 lora 0.8", card=CARD[0], image_seconds=call.seconds)
    check(not np.array_equal(styled, base), "lora: the image did not change")
    merged = [t.clone() for t in plan.tensors()]
    call("ckpt v1 lora per-call 0.3", cross_attention_kwargs={"scale": 0.3}, **kw)
    again = call("ckpt v1 lora after per-call", **kw)
    check(np.array_equal(again, styled),
          "lora: the per-call scale did not restore the image")
    check(all(torch.equal(a, b) for a, b in zip(plan.tensors(), merged)),
          "lora: the per-call scale did not restore every weight bitwise")
    merged = {f"{t}.{k}": v.clone() for t in ("unet", "text_encoder")
              for k, v in getattr(pipe, t).state_dict().items()}
    pipe.unload_lora_weights()
    after = {f"{t}.{k}": v for t in ("unet", "text_encoder")
             for k, v in getattr(pipe, t).state_dict().items()}
    worst, exact, total = 0.0, 0, 0
    for k, b in before.items():
        a, m = after[k], merged[k]
        if torch.equal(m, b):
            continue  # not touched
        err = (a.float() - b.float()).abs()
        ulp = bf16_ulp(torch.maximum(torch.maximum(a.float().abs(), b.float().abs()),
                                     m.float().abs()))
        check(bool((err <= ulp).all()), f"unload: {k} beyond one bf16 ulp")
        worst = max(worst, float((err / bf16_ulp(b)).max()))
        exact += int((err == 0).sum())
        total += err.numel()
    log(lora_unload=True, touched_values=total, exactly_restored=exact / total,
        max_error_in_base_ulps=worst)
    del before, merged, after

    # 3. a textual-inversion token
    ti_path = os.path.join(work, "cat-toy.safetensors")
    g = torch.Generator().manual_seed(3)
    dim = pipe.text_encoder.config.hidden_size
    _write(ti_path, {"<cat-toy>": torch.randn(2, dim, generator=g) * 0.02})
    ti_prompt = "a <cat-toy> on a red bench"
    plain_ids = torch.as_tensor(pipe.tokenizer([prompt]), device=device,
                                dtype=torch.long)
    with torch.no_grad():
        plain_before = pipe.text_encoder(plain_ids)
    no_ti = call("ckpt v1 token prompt before TI", **{**kw, "prompt": ti_prompt})
    pipe.add_textual_inversion(ti_path)
    with_ti = call("ckpt v1 token prompt with TI", **{**kw, "prompt": ti_prompt})
    with torch.no_grad():
        check(torch.equal(pipe.text_encoder(plain_ids), plain_before),
              "textual inversion: a prompt without the token encodes otherwise")
    d = np.abs(with_ti.astype(np.int32) - no_ti.astype(np.int32))
    log(textual_inversion="<cat-toy> x 2", max_uint8_diff=int(d.max()),
        mean_uint8_diff=float(d.mean()))
    check(d.max() > 0, "textual inversion: the image did not change")
    launches = _path_counts("checkpoints ppt-v1", expected_launches(v1_cfg, STEPS))
    del pipe, call
    torch.cuda.empty_cache()

    # 4. int8 + LoRA
    t0 = time.perf_counter()
    pipe8 = powerpaint_tpu_torch.load(root, "ppt-v1", int8=True).pipeline
    log(phase="setup", path="checkpoints ppt-v1 int8",
        seconds=time.perf_counter() - t0, x_scale=pipe8.int8_x_scale)
    pipe8.load_lora_weights(lora_path, scale=0.8)
    convs = [m for m in pipe8.unet.modules()
             if isinstance(m, Conv2D) and m.int8_x_scale is not None]
    for m in convs:
        w_q, w_scale = conv.quantize_weights_int8(m.weight)
        check(torch.equal(m.w_q, w_q) and torch.equal(m.w_scale, w_scale),
              "int8 lora: a conv's int8 weights are not those of its merged weight")
    sites, first = [], [True]

    def record(mod, args, kwargs, out):
        x = args[0]
        if first[0] and conv.int8_site(x.shape[1], x.shape[2], x.shape[3],
                                       mod.out_channels):
            sites.append((mod, x.detach().clone(), kwargs["gn"], out.detach().clone()))

    hooks = [m.register_forward_hook(record, with_kwargs=True) for m in convs]
    hooks.append(pipe8.unet.register_forward_hook(
        lambda *a: first.__setitem__(0, False)))
    call8 = _caller(pipe8, image, mask, lambda kw: expected_launches(
        v1_cfg, kw["num_inference_steps"], int8_hw=HW))
    reset_counts()  # the int8 calls start here
    call8("ckpt v1 int8 lora 0.8", **kw)
    for h in hooks:
        h.remove()
    n_sites = sum(conv.int8_site(*s) for s in unet_sites(v1_cfg.unet, HW // 8, HW // 8))
    check(len(sites) == n_sites, f"int8 lora: {len(sites)} units, not {n_sites}")
    worst, flips = 0.0, 0
    for m, x, gn, out in sites:
        want = conv.conv3x3_gn_silu_int8_plain(
            x, m.w_q, m.w_scale, m.bias_fp32, gn.weight, gn.bias,
            x_scale=m.int8_x_scale, num_groups=gn.num_groups, eps=gn.eps)
        err, ok, n = int8_check(out, want, x, m.w_q, m.w_scale, m.bias_fp32,
                                True, (gn.weight, gn.bias), gn.num_groups,
                                m.int8_x_scale)
        check(ok, f"int8 lora: a unit {tuple(x.shape)} is {err} from its plain "
                  "version, beyond the flip bound")
        worst, flips = max(worst, err), flips + n
    log(path="checkpoints ppt-v1 int8 lora", int8_units_checked=len(sites),
        max_abs_err=worst, flip_candidates=flips)
    int8_launches = _path_counts("checkpoints ppt-v1 int8",
                                 expected_launches(v1_cfg, STEPS, int8_hw=HW))
    del pipe8, call8, sites
    shutil.rmtree(root)
    torch.cuda.empty_cache()

    # 5. the ppt-v2 two-directory layout
    root = os.path.join(work, "ppt-v2")
    base_dir = os.path.join(root, "realisticVisionV60B1_v51VAE")
    bn_dir = os.path.join(root, "PowerPaint_Brushnet")
    state = _fp16_state(v2_cfg, device)
    files = {path: sd for path, sd in (
        (os.path.join(base_dir, "unet", "diffusion_pytorch_model.safetensors"),
         state["unet"]),
        (os.path.join(base_dir, "vae", "diffusion_pytorch_model.safetensors"),
         state["vae"]),
        (os.path.join(base_dir, "text_encoder", "model.safetensors"),
         _with_position_ids(state["text_encoder"])),
        (os.path.join(bn_dir, "diffusion_pytorch_model.safetensors"),
         state["brushnet"]),
        (os.path.join(bn_dir, "pytorch_model.bin"),
         _with_position_ids(state["text_encoder_brushnet"])))}
    t0 = time.perf_counter()
    nbytes = sum(_write(path, sd) for path, sd in files.items())
    write_s = time.perf_counter() - t0
    ref = BrushNetPipeline(v2_cfg, state, _tokenizer(v2_cfg),
                           dtype=torch.bfloat16, device=device)
    del state
    want = ref(image, mask, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe = powerpaint_tpu_torch.load(root, "ppt-v2").pipeline
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    read_s = _read_seconds(files)
    log(checkpoint="ppt-v2", card=CARD[0], bytes=nbytes, write_seconds=write_s,
        load_seconds=load_s, load_gb_per_s=nbytes / load_s / 1e9,
        read_seconds=read_s, read_gb_per_s=nbytes / read_s / 1e9)
    del files
    for f in ("unet", "vae", "text_encoder", "brushnet", "text_encoder_brushnet"):
        _same_weights(f"ppt-v2 load {f}", getattr(pipe, f), getattr(ref, f))
    del ref
    torch.cuda.empty_cache()
    call = _caller(pipe, image, mask, lambda kw: expected_launches_v2(
        v2_cfg, kw["num_inference_steps"]))
    reset_counts()  # the ppt-v2 call starts here
    got = call("ckpt v2 loaded", **kw)
    log(call="ckpt v2 loaded", card=CARD[0], image_seconds=call.seconds)
    check(np.array_equal(got, want),
          "ppt-v2 load: the image is not the in-memory pipeline's")
    v2_launches = _path_counts("checkpoints ppt-v2",
                               expected_launches_v2(v2_cfg, STEPS))
    del pipe, call
    shutil.rmtree(work)
    torch.cuda.empty_cache()
    return {k: launches[k] + int8_launches[k] + v2_launches[k] for k in launches}


# ---------------------------------------------------------------------------
# phase 7e: the call surface
# ---------------------------------------------------------------------------

PORTRAIT = (768, 512)
PORTRAIT_INPUT = (640, 480)
# phase 7b: a processed size off the 64-pixel grid on one side, so HED
# resizes to its bucket (512 x 576) and back
OFF_BUCKET = (512, 600)
CUSTOM_GRID = [999, 950, 900, 850, 800, 700, 600, 500, 400, 300, 250, 200,
               150, 100, 75, 50, 25, 10]
TIMESTEPS_ERROR = ("explicit timesteps= lists are only supported with the "
                   "unipc scheduler on the v2 pipeline")
BPE_PROMPTS = ["a red bench in a park", "A Cat, sitting!  on a sofa",
               "blurry, low quality, watermark", "an old wooden boat on a "
               "lake at sunset", "portrait of a woman, 85mm, f/1.8",
               "remove the person", "a vase of flowers on a table", "",
               "café crème brûlée", "two dogs playing in the snow 4k"]


def _capture_cond(pipe, v2: bool) -> dict:
    """Wrap ``pipe._encode_prompts`` to keep the (negative, positive)
    embeddings of the blended pair (ppt-v2: the branch's) it returns, as
    float32 numpy."""
    box, inner = {}, pipe._encode_prompts

    def wrapped(*a, **kw):
        out = inner(*a, **kw)
        cond = out[0] if v2 else out
        b = cond.shape[0] // 2
        box["dtype"] = cond.dtype
        box["neg"] = cond[:b].float().cpu().numpy()
        box["pos"] = cond[b:].float().cpu().numpy()
        return out

    pipe._encode_prompts = wrapped
    return box


def _embeds_calls(call, box, label, **kw):
    """The plain call, then one with its own blended pair given back as
    numpy fp32: the image must be bitwise the same. Returns the image and
    the plain call's seconds."""
    base = call(f"{label} plain", **kw)
    seconds = call.seconds
    check(box["dtype"] == torch.float32,
          f"{label}: the blended pair is {box['dtype']}, not float32")
    given = call(f"{label} prompt_embeds", prompt_embeds=box["pos"],
                 negative_prompt_embeds=box["neg"], **kw)
    check(np.array_equal(given, base),
          f"{label}: prompt_embeds did not give the plain call's image")
    log(call=f"{label} prompt_embeds", card=CARD[0], seconds=call.seconds,
        plain_seconds=seconds)
    return base, seconds


def _int8_units(pipe):
    """Record every int8 unit of the UNet's first evaluation of the next
    call: returns (records, remove)."""
    from powerpaint_tpu_torch.models.layers import Conv2D
    from powerpaint_tpu_torch.ops import conv

    sites, first = [], [True]

    def record(mod, args, kwargs, out):
        x = args[0]
        if first[0] and conv.int8_site(x.shape[1], x.shape[2], x.shape[3],
                                       mod.out_channels):
            sites.append((mod, x.detach().clone(), kwargs["gn"],
                          out.detach().clone()))

    hooks = [m.register_forward_hook(record, with_kwargs=True)
             for m in pipe.unet.modules()
             if isinstance(m, Conv2D) and m.int8_x_scale is not None]
    hooks.append(pipe.unet.register_forward_hook(
        lambda *a: first.__setitem__(0, False)))
    return sites, lambda: [h.remove() for h in hooks]


def _check_int8_units(label: str, sites) -> None:
    from powerpaint_tpu_torch.ops import conv

    worst, flips = 0.0, 0
    for m, x, gn, out in sites:
        want = conv.conv3x3_gn_silu_int8_plain(
            x, m.w_q, m.w_scale, m.bias_fp32, gn.weight, gn.bias,
            x_scale=m.int8_x_scale, num_groups=gn.num_groups, eps=gn.eps)
        err, ok, n = int8_check(out, want, x, m.w_q, m.w_scale, m.bias_fp32,
                                True, (gn.weight, gn.bias), gn.num_groups,
                                m.int8_x_scale)
        check(ok, f"{label}: an int8 unit {tuple(x.shape)} is {err} from its "
                  "plain version, beyond the flip bound")
        worst, flips = max(worst, err), flips + n
    log(path=label, int8_units_checked=len(sites), max_abs_err=worst,
        flip_candidates=flips)


def learn_bpe(texts, n_merges: int):
    """A byte-level CLIP-style vocabulary and merges learned from ``texts``
    (the most frequent pair merged first): every byte alone and with
    ``</w>``, the merges, the two special tokens."""
    from powerpaint_tpu_torch.text.tokenizer import bytes_to_unicode, segment_words

    b2u = bytes_to_unicode()
    words = {}
    for t in texts:
        for w in segment_words(t):
            s = [b2u[b] for b in w.encode("utf-8")]
            s[-1] += "</w>"
            words[tuple(s)] = words.get(tuple(s), 0) + 1
    vocab = {}
    for c in b2u.values():
        vocab[c] = len(vocab)
    for c in b2u.values():
        vocab[c + "</w>"] = len(vocab)
    merges = []
    for _ in range(n_merges):
        pairs = {}
        for w, n in words.items():
            for p in zip(w[:-1], w[1:]):
                pairs[p] = pairs.get(p, 0) + n
        if not pairs:
            break
        best = max(sorted(pairs), key=pairs.get)
        merges.append(best)
        vocab.setdefault(best[0] + best[1], len(vocab))
        new = {}
        for w, n in words.items():
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and (w[i], w[i + 1]) == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            new[tuple(out)] = new.get(tuple(out), 0) + n
        words = new
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    return vocab, merges


def run_call_surface_path(device):
    """Phase 7e: the call surface at full width, bf16 (and int8 once),
    guidance 7.5. ppt-v1 (20 DDIM steps, 512^2): the blended embeddings of
    a call given back as ``prompt_embeds`` (bitwise the image, the text
    encoder's 25 LayerNorms not launched), a callback every 5 steps
    (bitwise the image, the launches unchanged); a portrait call, a 640 x
    480 input to ``height=768, width=512``, in bf16 and int8 (the int8 units
    of its first evaluation within ``int8_check``). ppt-v2 (20 UniPC
    steps): ``prompt_embeds`` (the task tower not launched), then the
    18-step custom grid at 768 x 512 (18 evaluations), and the refusal of
    ``timesteps=`` on DDIM. A full-width ControlNet (seed 1) written in
    fp16 as a diffusers directory, loaded by ``load_controlnet`` (every
    tensor the source cast as the pipelines cast it), a 20-step portrait
    call over the ppt-v1 stack, and the command line's ``--control_type hed``
    and ``canny`` with ``--controlnet_dir`` on the demo stack. The natives:
    the portrait blend against numpy, the BPE's ids against the Python
    BPE's. Launches exact per call."""
    import contextlib
    import dataclasses
    import io
    import os
    import re
    import shutil

    from PIL import Image

    from powerpaint_tpu_torch.core.config import (
        ppt_v1_config,
        ppt_v1_controlnet_config,
        ppt_v2_config,
    )
    from powerpaint_tpu_torch.core.validation import InputValidationError
    from powerpaint_tpu_torch.io.checkpoint import load_controlnet
    from powerpaint_tpu_torch.io.weights import build_models, init_state, random_state
    from powerpaint_tpu_torch.ops import _build
    from powerpaint_tpu_torch.ops.conv import int8_site
    from powerpaint_tpu_torch.pipelines.brushnet import BrushNetPipeline
    from powerpaint_tpu_torch.pipelines.common import apply_target_hw
    from powerpaint_tpu_torch.pipelines.controlnet import ControlNetPipeline
    from powerpaint_tpu_torch.pipelines.inpaint import InpaintPipeline
    from powerpaint_tpu_torch.serve import cli
    from powerpaint_tpu_torch.tasks import control, postprocess
    from powerpaint_tpu_torch.text import native as native_bpe
    from powerpaint_tpu_torch.text.tokenizer import ClipBPETokenizer

    v1_cfg, v2_cfg = ppt_v1_config(), ppt_v2_config()
    prompt = "a red bench in a park"
    image, mask = inputs(HW, 0)
    portrait_in = inputs(PORTRAIT_INPUT, 2)
    total = {k: 0 for k in KERNELS}

    def path_done(label, one_call):
        for k, n in _path_counts(label, one_call).items():
            total[k] += n

    def build(cls, cfg, **kw):
        state = init_state(cfg, torch.Generator(device=device).manual_seed(0),
                           device=device, dtype=torch.bfloat16)
        return cls(cfg, state, _tokenizer(cfg), dtype=torch.bfloat16,
                   device=device, **kw)

    # 1. ppt-v1: prompt_embeds, the callback, the portrait call
    t0 = time.perf_counter()
    pipe = build(InpaintPipeline, v1_cfg)
    log(phase="setup", path="call surface ppt-v1", seconds=time.perf_counter() - t0)

    def v1_expected(kw):
        return expected_launches(
            v1_cfg, kw["num_inference_steps"],
            text_encoder=kw.get("negative_prompt_embeds") is None)

    call = _caller(pipe, image, mask, v1_expected)
    box = _capture_cond(pipe, v2=False)
    latents = {}
    decode = pipe._decode
    pipe._decode = lambda z: latents.__setitem__("final", z.float().cpu().numpy()) \
        or decode(z)
    kw = dict(prompt=prompt, seed=1)
    call("surface v1 warm-up", prompt="a cat", seed=99)
    reset_counts()  # the path starts here
    base, plain_s = _embeds_calls(call, box, "surface v1", **kw)
    fewer = (expected_launches(v1_cfg, STEPS)["layer_norm"]
             - v1_expected({"num_inference_steps": STEPS,
                            "negative_prompt_embeds": 0})["layer_norm"])
    n_text = 2 * v1_cfg.text_encoder.num_hidden_layers + 1  # 25 at full width
    log(path="surface v1", layer_norms_spared_by_prompt_embeds=fewer)
    check(fewer == n_text, f"surface v1: prompt_embeds spares {fewer} "
                           f"LayerNorms, not {n_text}")
    seen = []
    got = call("surface v1 callback every 5", callback=lambda i, x: seen.append(
        (i, x)), callback_steps=5, **kw)
    log(call="surface v1 callback every 5", card=CARD[0], seconds=call.seconds,
        plain_seconds=plain_s, callback_steps=[i for i, _ in seen])
    check([i for i, _ in seen] == list(range(0, STEPS, 5)),
          f"callback: called at {[i for i, _ in seen]}")
    check(all(x.shape == (1, HW // 8, HW // 8, 4) and x.dtype == np.float32
              for _, x in seen), "callback: latents of another shape")
    check(not np.array_equal(seen[-1][1], latents["final"]),
          f"callback: the latents at i = {seen[-1][0]} are the final ones")
    check(np.array_equal(got, base), "callback: the image changed")
    portrait = call("surface v1 portrait 768x512", at=portrait_in,
                    height=PORTRAIT[0], width=PORTRAIT[1], **kw)
    check(portrait.shape == (1, *PORTRAIT, 3),
          f"portrait: output {portrait.shape}")
    portrait_s = call.seconds
    ms_512 = denoise_device_ms(pipe, lambda: pipe(image, mask, **kw,
                                                  num_inference_steps=STEPS))
    ms_portrait = denoise_device_ms(pipe, lambda: pipe(
        *portrait_in, height=PORTRAIT[0], width=PORTRAIT[1], **kw,
        num_inference_steps=STEPS))
    log(path="surface v1 portrait", card=CARD[0], seconds_per_image=portrait_s,
        seconds_per_image_512=plain_s, denoise_device_ms=ms_portrait,
        denoise_device_ms_512=ms_512,
        device_ms_ratio=(ms_portrait / ms_512) if ms_512 and ms_portrait else None)
    path_done("call surface ppt-v1", expected_launches(v1_cfg, STEPS))

    # 2. the natives on the portrait result
    img_p, mask_p = apply_target_hw(*portrait_in, *PORTRAIT, False)
    blended = postprocess.blend_result(portrait[0], img_p, mask_p)
    plain = postprocess.blend_result_plain(portrait[0], img_p, mask_p)
    d = np.abs(blended.astype(np.int32) - plain.astype(np.int32))
    native_ms = host_ms(lambda: postprocess.blend_result(portrait[0], img_p, mask_p),
                        iters=5, warmup=1)
    numpy_ms = host_ms(lambda: postprocess.blend_result_plain(
        portrait[0], img_p, mask_p), iters=5, warmup=1)
    log(natives="blend 768x512", card=CARD[0], host_cpus=os.cpu_count(),
        gxx_native_target=_build._native_target(),
        max_uint8_diff_vs_numpy=int(d.max()),
        values_differing=int((d > 0).sum()), native_ms=native_ms, numpy_ms=numpy_ms)
    check(d.max() <= 1, f"native blend: {d.max()} levels from the numpy blend "
                        "(Queue C's bound: 1, rounding against truncation)")
    vocab, merges = learn_bpe(BPE_PROMPTS, 400)
    py_tok, c_tok = ClipBPETokenizer(vocab, merges), native_bpe.NativeBPETokenizer(
        vocab, merges)
    ids = [c_tok.encode_text(t) for t in BPE_PROMPTS]
    t0 = time.perf_counter()
    want_ids = [py_tok.encode_text(t) for t in BPE_PROMPTS]
    py_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for t in BPE_PROMPTS:
        c_tok.encode_text(t)
    c_s = time.perf_counter() - t0
    log(natives="bpe", vocab=len(vocab), merges=len(merges), prompts=len(ids),
        ids=sum(map(len, ids)), identical=ids == want_ids, native_ms=c_s * 1e3,
        python_ms=py_s * 1e3)
    check(ids == want_ids, "native BPE: ids differ from the Python BPE's")

    # 3. the portrait call with int8 on
    t0 = time.perf_counter()
    pipe8 = build(InpaintPipeline, v1_cfg, int8=True)
    log(phase="setup", path="call surface ppt-v1 int8",
        seconds=time.perf_counter() - t0)
    want8 = expected_launches(v1_cfg, STEPS, int8_hw=PORTRAIT)
    call8 = _caller(pipe8, *portrait_in, lambda kw: want8)
    pkw = dict(kw, height=PORTRAIT[0], width=PORTRAIT[1])
    call8("surface v1 int8 portrait warm-up", **pkw)
    sites, remove = _int8_units(pipe8)
    reset_counts()  # the int8 call starts here
    out8 = call8("surface v1 int8 portrait 768x512", **pkw)
    remove()
    n_sites = sum(int8_site(*s) for s in unet_sites(
        v1_cfg.unet, PORTRAIT[0] // 8, PORTRAIT[1] // 8))
    check(len(sites) == n_sites, f"int8 portrait: {len(sites)} units, not {n_sites}")
    _check_int8_units("surface v1 int8 portrait", sites)
    log(path="surface v1 int8 portrait", card=CARD[0], seconds_per_image=call8.seconds,
        int8_units_per_evaluation=n_sites, launches_expected=want8,
        psnr_vs_bf16=psnr(out8, portrait))
    path_done("call surface ppt-v1 int8", want8)
    del pipe8, call8, sites
    torch.cuda.empty_cache()

    # 4. the ControlNet directory, a portrait call over the ppt-v1 stack
    work = os.path.join("smoke_out", "controlnet")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cn_cfg = ppt_v1_controlnet_config()
    model = build_models(cn_cfg)["controlnet"]
    need = 2 * sum(p.numel() for p in model.parameters()) + (1 << 30)
    free = shutil.disk_usage(work).free
    log(phase="controlnet directory", disk_free_bytes=free, disk_needed_bytes=need)
    check(free >= need, f"controlnet: {free} bytes free under {work}, {need} needed")
    src = {k: v.half() for k, v in random_state(
        model, torch.Generator(device=device).manual_seed(1), device=device,
        dtype=torch.float16).items()}
    with open(os.path.join(work, "config.json"), "w") as f:
        json.dump({"_class_name": "ControlNetModel",
                   **dataclasses.asdict(cn_cfg.controlnet.base), "in_channels": 4,
                   "conditioning_channels": cn_cfg.controlnet.conditioning_channels,
                   "conditioning_embedding_out_channels":
                       list(cn_cfg.controlnet.conditioning_embedding_out_channels)},
                  f)
    nbytes = _write(os.path.join(work, "diffusion_pytorch_model.safetensors"), src)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    branch = load_controlnet(work)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    log(checkpoint="controlnet", card=CARD[0], bytes=nbytes, load_seconds=load_s,
        load_gb_per_s=nbytes / load_s / 1e9,
        params=sum(p.numel() for p in branch.parameters()))
    got_sd = branch.state_dict()
    check(got_sd.keys() == src.keys(), "controlnet load: state-dict names differ")
    linear = {f"{n}.{p}" for n, m in branch.named_modules()
              if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d))
              for p, _ in m.named_parameters(recurse=False)}
    bad = [k for k, v in got_sd.items()
           if v.dtype != (torch.bfloat16 if k in linear else torch.float32)
           or not torch.equal(v, src[k].to(v.dtype))]
    check(not bad, f"controlnet load: {len(bad)} tensors are not the source's, "
                   f"e.g. {bad[:3]}")
    check(branch.config == cn_cfg.controlnet.replace(
        base=cn_cfg.controlnet.base.replace(in_channels=4)),
        f"controlnet load: config {branch.config}")
    del src, got_sd
    cn = ControlNetPipeline.from_pipeline(pipe, branch)
    cn_want = expected_launches_cn(cn.config, STEPS)
    call_cn = _caller(cn, *portrait_in, lambda kw: cn_want,
                      models=(("controlnet", "denoise_controlnet"),
                              ("unet", "denoise_base_unet")))
    edges = edge_map(PORTRAIT_INPUT[0], 4)[:, :PORTRAIT_INPUT[1]]
    reset_counts()  # the ControlNet call starts here
    out_cn = call_cn("surface cn loaded portrait 768x512", control_image=edges,
                     **pkw)
    d = np.abs(out_cn.astype(np.int32) - portrait.astype(np.int32))
    log(path="surface cn portrait", card=CARD[0], seconds_per_image=call_cn.seconds,
        vs_v1_portrait_max_uint8_diff=int(d.max()))
    check(out_cn.shape == (1, *PORTRAIT, 3) and d.max() > 0,
          "controlnet portrait: the branch changed nothing")
    path_done("call surface controlnet", cn_want)
    del cn, call_cn, branch, pipe, call
    torch.cuda.empty_cache()

    # 5. the command line: --control_type hed, then canny, --controlnet_dir
    # on the demo stack (a 512^2 image; canny's map is the host's)
    out_dir = os.path.join("smoke_out", "cli_control")
    os.makedirs(out_dir, exist_ok=True)
    cli_image, cli_mask = inputs(HW, 5)
    paths = {k: os.path.join(out_dir, f"{k}.png") for k in ("image", "mask", "out")}
    Image.fromarray(cli_image).save(paths["image"])
    Image.fromarray((cli_mask * 255).astype(np.uint8)).save(paths["mask"])
    cli_want = expected_launches_cn(cn_cfg, STEPS)
    for kind in ("hed", "canny"):
        argv = ["--image", paths["image"], "--mask", paths["mask"], "--output",
                paths["out"], "--prompt", prompt, "--steps", str(STEPS),
                "--short_side", str(HW), "--seed", "1", "--control_type", kind,
                "--controlnet_dir", work]
        control._REGISTRY.pop("hed", None)  # the command's own random HED
        reset_counts()  # the command starts here
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            rc = cli.main(argv)
        secs = time.perf_counter() - t0
        launches = read_counts()
        lines = printed.getvalue().strip().splitlines()
        log(path=f"cli control {kind}", card=CARD[0], argv=argv, rc=rc,
            printed=lines, seconds=secs, launches=launches)
        check(rc == 0, f"cli control {kind}: exit code {rc}")
        check(launches == cli_want,
              f"cli control {kind}: launches {launches}, expected {cli_want}")
        check(len(lines) >= 2 and re.fullmatch(
            rf"control: {kind} map \({HW}x{HW}\) in [0-9.]+s", lines[-2]) is not None
            and re.fullmatch(rf"wrote {re.escape(paths['out'])} \({HW}x{HW}\) in "
                             rf"[0-9.]+s \({STEPS} steps, control {kind}\)", lines[-1])
            is not None, f"cli control {kind}: output {lines}")
        with Image.open(paths["out"]) as im:
            check(im.size == (HW, HW) and im.mode == "RGB",
                  f"cli control {kind}: wrote {im.size} {im.mode}")
        path_done(f"call surface cli control {kind}", cli_want)
    shutil.rmtree(work)
    torch.cuda.empty_cache()

    # 6. ppt-v2: prompt_embeds, then the custom grid at 768 x 512
    t0 = time.perf_counter()
    pipe = build(BrushNetPipeline, v2_cfg)
    log(phase="setup", path="call surface ppt-v2", seconds=time.perf_counter() - t0)

    def v2_expected(kw):
        steps = (len(kw["timesteps"]) if kw.get("timesteps")
                 else kw["num_inference_steps"])
        return expected_launches_v2(
            v2_cfg, steps, task_tower=kw.get("negative_prompt_embeds") is None)

    call = _caller(pipe, image, mask, v2_expected,
                   models=(("brushnet", "denoise_brushnet"),
                           ("unet", "denoise_base_unet")))
    box = _capture_cond(pipe, v2=True)
    call("surface v2 warm-up", prompt="a cat", seed=99)
    reset_counts()  # the path starts here
    _embeds_calls(call, box, "surface v2", **kw)
    evals = []
    hook = pipe.unet.register_forward_pre_hook(lambda *a: evals.append(1))
    grid = call("surface v2 custom grid 768x512", at=portrait_in,
                timesteps=CUSTOM_GRID, height=PORTRAIT[0], width=PORTRAIT[1], **kw)
    hook.remove()
    log(call="surface v2 custom grid 768x512", card=CARD[0],
        unet_evaluations=len(evals), seconds_per_image=call.seconds)
    check(len(evals) == len(CUSTOM_GRID),
          f"custom grid: {len(evals)} evaluations, not {len(CUSTOM_GRID)}")
    check(grid.shape == (1, *PORTRAIT, 3), f"custom grid: output {grid.shape}")
    try:
        pipe(image, mask, prompt=prompt, timesteps=CUSTOM_GRID, scheduler="ddim")
        refused = None
    except InputValidationError as e:
        refused = str(e)
    check(refused == TIMESTEPS_ERROR, f"timesteps= on ddim: {refused!r}")
    path_done("call surface ppt-v2", expected_launches_v2(v2_cfg, STEPS))
    del pipe, call
    torch.cuda.empty_cache()
    return total


# diffusers' cross-attention/asymmetric-autoencoder-kl-x-1-5 (its config):
# the SD1.5 encoder, a decoder at 1.5x the widths with 3 resnets a level (4
# an up block), and the condition tower that MaskConditionEncoder(in_ch=3,
# out_ch=192, res_ch=768, stride=16) builds
ASYM_X15 = dict(asymmetric=True, up_block_out_channels=(192, 384, 768, 768),
                layers_per_up_block=3,
                condition_layers=((3, 1, 192), (3, 1, 384), (4, 2, 768),
                                  (4, 2, 768), (4, 2, 768)))
# 1, 2, 3 and 4 until the training phase came; 3 cut to keep the script
# inside its time
CACHE_INTERVALS = (1, 2, 4)
FREEU = (1.5, 1.6, 0.9, 0.2)
# decode_tiled's tile and overlap (its defaults), and the latents of a
# 2048^2 outpainting canvas (25 tiles, also decoded in one pass) and of a
# 768 x 512 one (2 tiles, H != W)
TILE, OVERLAP = 64, 16
TILED_CANVASES = (((256, 256), 25, True), ((96, 64), 2, False))


def blend_shapes(v, h: int, w: int):
    """(H, W, C) of the asymmetric decoder's samples where it may blend
    (before each up block, and at full size after the last) and of its
    condition features, for an h x w image (4x4 stride-2 convs with padding
    1 halve even sides)."""
    ch = v.up_channels[::-1]
    n = len(ch)
    samples = [(h >> (n - 1 - i), w >> (n - 1 - i), ch[max(i - 1, 0)])
               for i in range(n)] + [(h, w, ch[-1])]
    feats, fh, fw = [], h, w
    for _, stride, c in v.condition_layers:
        fh, fw = fh // stride, fw // stride
        feats.append((fh, fw, c))
    return samples, feats


def device_ms(fn, families: dict = None, top: list = None) -> float:
    """Device time in ms of the kernels ``fn()`` launches, under
    ``torch.profiler`` (None where it records no device time); with a dict
    ``families``, its split by kernel family (``by_family``) goes there,
    and with a list ``top``, the kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [(e.key, e.self_device_time_total, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if families is not None:
        families.update(by_family(kernels))
    if top is not None:
        top.extend(dict(name=n[:90], ms=t / 1e3, calls=c)
                   for n, t, c in sorted(kernels, key=lambda k: -k[1]))
    us = sum(t for _, t, _ in kernels)
    return us / 1e3 if us else None


def host_seconds(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def run_vae_extras_path(device):
    """Phase 7f: the VAE extras and the approximation modes at full width,
    bf16, random weights from seeds, 512^2, guidance 7.5. The asymmetric
    ppt-v1 (``ASYM_X15``'s decoder and condition tower, the spec checked
    against the decoder's blend shapes): 20 DDIM steps, two tasks and a
    bitwise repeat; the decode's seconds and device ms beside the SD1.5
    decoder's on the same latents; on the card, an all-hole mask makes two
    images decode bitwise alike and a half mask does not; the stack
    written in fp16 in the ppt-v1 layout and loaded by
    ``powerpaint_tpu_torch.load`` (every tensor and the image bitwise); one
    int8 call, its decoder split by ``int8_site``. ``decode_tiled`` on the
    SD1.5 VAE: a 2048^2 canvas in 25 tiles and in one pass (mid attention
    at S = 65536), seconds, device ms, peak memory and their mean
    difference, and a 768 x 512 canvas in 2 tiles. Encoder propagation on
    ppt-v1 at intervals 1, 2 and 4 and the BrushNet branch's cache on
    ppt-v2 at interval 2 (denoise device ms and PSNR against interval 1);
    FreeU on ppt-v1 (the image differs, the launches do not). ControlNet refuses an
    encoder cache. Launches exact per call and per decode."""
    import gc
    import os
    import shutil

    import powerpaint_tpu_torch
    from powerpaint_tpu_torch.core.config import (
        ppt_v1_config,
        ppt_v1_controlnet_config,
        ppt_v2_config,
    )
    from powerpaint_tpu_torch.io.weights import _load, init_state, random_state
    from powerpaint_tpu_torch.models.controlnet import ControlNetModel
    from powerpaint_tpu_torch.models.vae import AutoencoderKL, decode_tiled
    from powerpaint_tpu_torch.ops.conv import int8_site
    from powerpaint_tpu_torch.ops.freeu import FreeUConfig
    from powerpaint_tpu_torch.pipelines.brushnet import BrushNetPipeline
    from powerpaint_tpu_torch.pipelines.controlnet import ControlNetPipeline
    from powerpaint_tpu_torch.pipelines.inpaint import InpaintPipeline

    v1 = ppt_v1_config()
    cfg = v1.replace(vae=v1.vae.replace(**ASYM_X15))
    prompt = "a red bench in a park"
    image, mask = inputs(HW, 0)
    total = {k: 0 for k in KERNELS}

    def path_done(label, one_call):
        for k, n in _path_counts(label, one_call).items():
            total[k] += n

    samples, feats = blend_shapes(cfg.vae, HW, HW)
    log(path="vae extras", blend_samples=samples, condition_features=feats)
    check(all(f in samples for f in feats) and len(set(feats)) == len(feats),
          f"asymmetric spec: features {feats} do not each match a sample {samples}")

    # 1. the asymmetric ppt-v1 stack, its weights fp16 values (a checkpoint's)
    t0 = time.perf_counter()
    state = _fp16_state(cfg, device)
    pipe = InpaintPipeline(cfg, state, _tokenizer(cfg), dtype=torch.bfloat16,
                           device=device)
    vae_params = sum(p.numel() for p in pipe.vae.parameters())
    log(phase="setup", path="asymmetric ppt-v1", card=CARD[0],
        params=sum(p.numel() for m in (pipe.unet, pipe.vae, pipe.text_encoder)
                   for p in m.parameters()),
        vae_params=vae_params,
        decoder_params=sum(p.numel() for p in pipe.vae.decoder.parameters()),
        condition_tower_params=sum(
            p.numel() for p in pipe.vae.decoder.condition_encoder.parameters()),
        seconds=time.perf_counter() - t0)
    # the blend shapes on the card: the up blocks' and the output norm's
    # inputs, and the tower's features
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.append(tuple(args[0].shape[1:])))
        for m in (*pipe.vae.decoder.up_blocks, pipe.vae.decoder.conv_norm_out)]
    with torch.no_grad():
        z = torch.randn((1, HW // 8, HW // 8, 4), device=device,
                        generator=torch.Generator(device=device).manual_seed(5))
        img_t = torch.as_tensor(image[None], device=device).float() / 127.5 - 1.0
        mask_t = torch.as_tensor((mask >= 0.5)[None, ..., None], device=device).float()
        pipe.vae.decode_with_condition(z, img_t, mask_t)
        got_feats = [tuple(f.shape[1:]) for f in
                     pipe.vae.decoder.condition_encoder(img_t.bfloat16())]
    for hk in hooks:
        hk.remove()
    check(seen == samples and got_feats == feats,
          f"asymmetric decode on the card: samples {seen}, features {got_feats}")

    def v1_expected(kw):
        return expected_launches(
            cfg, kw["num_inference_steps"],
            encoder_cache_interval=kw.get("encoder_cache_interval", 1))

    call = _caller(pipe, image, mask, v1_expected)
    kw = dict(prompt=prompt, seed=1)
    call("asym v1 warm-up", prompt="a cat", seed=99, num_inference_steps=2)
    reset_counts()  # the path starts here
    outs = {t: call(f"asym v1 {t}", task=t, **kw)
            for t in ("text-guided", "object-removal")}
    box, inner = {}, pipe._decode  # the repeat's latents, for the decode alone
    pipe._decode = lambda lat, *a: (box.setdefault("lat", lat.clone()),
                                    inner(lat, *a))[1]
    again = call("asym v1 text-guided same seed", **kw)
    pipe._decode = inner
    check(np.array_equal(again, outs["text-guided"]),
          "asymmetric v1: the same seed gave a different image")

    # the decode alone, beside the SD1.5 decoder's on the same latents
    with torch.device("meta"):
        sd_vae = AutoencoderKL(v1.vae)
    sd_vae = _load(sd_vae, random_state(sd_vae, torch.Generator(device=device)
                                        .manual_seed(3), device, torch.bfloat16),
                   device, torch.bfloat16, None)
    with torch.no_grad():
        zd = (box["lat"] / cfg.vae.scaling_factor).to(torch.bfloat16)
        asym_dec = lambda: pipe.vae.decode_with_condition(zd, img_t, mask_t)  # noqa: E731
        sd_dec = lambda: sd_vae.decode(zd)  # noqa: E731
        asym_dec(), sd_dec()  # warm-up
        fam_asym, fam_sd = {}, {}
        row = dict(asym_seconds=host_seconds(asym_dec), sd_seconds=host_seconds(sd_dec),
                   asym_device_ms=device_ms(asym_dec, fam_asym),
                   sd_device_ms=device_ms(sd_dec, fam_sd),
                   asym_device_ms_by_family=fam_asym, sd_device_ms_by_family=fam_sd)
        if row["asym_device_ms"] and row["sd_device_ms"]:
            row["device_ratio"] = row["asym_device_ms"] / row["sd_device_ms"]
        log(decode="asymmetric x-1-5 vs SD1.5 at 512^2", card=CARD[0],
            asym_vae_params=vae_params,
            sd_vae_params=sum(p.numel() for p in sd_vae.parameters()), **row)
        # the mask semantics on the card
        img_b = torch.as_tensor(inputs(HW, 7)[0][None], device=device).float() / 127.5 - 1
        hole = torch.ones_like(mask_t)
        half = hole.clone()
        half[:, :, : HW // 2] = 0.0
        dec = pipe.vae.decode_with_condition
        check(torch.equal(dec(zd, img_t, hole), dec(zd, img_b, hole)),
              "asymmetric decode: an all-hole mask let the image through")
        check(not torch.equal(dec(zd, img_t, half), dec(zd, img_b, half)),
              "asymmetric decode: a half mask did not let the image through")
    dec_launches = _total((1, vae_launches(cfg.vae, True)),
                          (1, vae_launches(v1.vae, True)))
    path_done("asymmetric ppt-v1", _total((1, v1_expected({"num_inference_steps": STEPS})),
                                          (1, dec_launches)))

    # 2. the stack written in fp16 in the ppt-v1 layout, loaded
    work = os.path.join("smoke_out", "asymmetric")
    shutil.rmtree(work, ignore_errors=True)
    files = {os.path.join(work, *rel): sd for rel, sd in (
        (("unet", "diffusion_pytorch_model.safetensors"), state["unet"]),
        (("text_encoder", "model.safetensors"),
         _with_position_ids(state["text_encoder"])),
        (("vae", "diffusion_pytorch_model.safetensors"), state["vae"]))}
    nbytes = sum(_write(path, sd) for path, sd in files.items())
    del files
    int8_pipe = InpaintPipeline(cfg, state, _tokenizer(cfg), dtype=torch.bfloat16,
                                device=device, int8=True)
    del state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loaded = powerpaint_tpu_torch.load(work, "ppt-v1").pipeline
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    log(checkpoint="asymmetric ppt-v1", card=CARD[0], bytes=nbytes,
        load_seconds=load_s, load_gb_per_s=nbytes / load_s / 1e9)
    check(loaded.config.vae == cfg.vae,
          f"asymmetric load: config {loaded.config.vae}, not {cfg.vae}")
    for f in ("unet", "vae", "text_encoder"):
        _same_weights(f"asymmetric load {f}", getattr(loaded, f), getattr(pipe, f))
    lcall = _caller(loaded, image, mask, v1_expected)
    reset_counts()
    got = lcall("asym v1 loaded", **kw)
    check(np.array_equal(got, outs["text-guided"]),
          "asymmetric load: the image is not the in-memory pipeline's")
    path_done("asymmetric ppt-v1 loaded", v1_expected({"num_inference_steps": STEPS}))
    del loaded, lcall
    gc.collect()  # the timing wrappers make the pipelines reference cycles
    shutil.rmtree(work, ignore_errors=True)

    # 3. int8: the decoder's units split by int8_site
    sites = vae_sites(cfg.vae, HW, HW, True)
    n_int8 = sum(int8_site(*s) for s in sites)
    i8_expected = lambda kw: expected_launches(cfg, kw["num_inference_steps"],  # noqa: E731
                                               int8_hw=HW)
    icall = _caller(int8_pipe, image, mask, i8_expected)
    icall("asym v1 int8 warm-up", prompt="a cat", seed=99, num_inference_steps=2)
    reset_counts()
    i8 = icall("asym v1 int8", **kw)
    log(path="asymmetric ppt-v1 int8", card=CARD[0],
        decoder_units=len(sites), decoder_int8_units=n_int8,
        psnr_vs_bf16=psnr(i8, outs["text-guided"]), seconds_per_image=icall.seconds)
    path_done("asymmetric ppt-v1 int8", i8_expected({"num_inference_steps": STEPS}))
    del int8_pipe, icall
    gc.collect()
    torch.cuda.empty_cache()

    # 4. decode_tiled on the SD1.5 VAE
    reset_counts()
    for (h8, w8), tiles, one_pass in TILED_CANVASES:
        zt = torch.randn((1, h8, w8, 4), device=device,
                         generator=torch.Generator(device=device).manual_seed(11))
        zt = zt.to(torch.bfloat16)
        rows, imgs = {}, {}
        for label, fn in (("tiled", lambda: decode_tiled(sd_vae, zt, tile=TILE,
                                                         overlap=OVERLAP)),
                          ("one pass", lambda: sd_vae.decode(zt))):
            if label == "one pass" and not one_pass:
                continue
            with torch.no_grad():
                torch.cuda.reset_peak_memory_stats()
                resident = torch.cuda.memory_allocated()
                before = read_counts()
                secs = host_seconds(lambda: imgs.setdefault(label, fn()))
                after = read_counts()
                got_l = {k: after[k] - before[k] for k in after}
                want_l = _total((tiles if label == "tiled" else 1,
                                 vae_launches(v1.vae, True)))
                check(got_l == want_l, f"decode_tiled {label} {h8}x{w8}: launches "
                                       f"{got_l}, expected {want_l}")
                peak = torch.cuda.max_memory_allocated()
                ms = device_ms(fn)
            img = imgs[label]
            check(img.shape == (1, 8 * h8, 8 * w8, 3) and img.dtype == torch.bfloat16
                  and bool(torch.isfinite(img).all()),
                  f"decode_tiled {label}: {tuple(img.shape)} {img.dtype}")
            rows[label] = dict(seconds=secs, device_ms=ms, launches=got_l,
                               max_memory_allocated=peak,
                               peak_above_resident_bytes=peak - resident)
        diff = (float((imgs["tiled"].float() - imgs["one pass"].float()).abs().mean())
                if "one pass" in imgs else None)
        log(decode_tiled=[8 * h8, 8 * w8], card=CARD[0], tiles=tiles, tile=TILE,
            overlap=OVERLAP, mean_abs_diff_tiled_vs_one_pass=diff, **rows)
    path_done("decode_tiled", _total((1, vae_launches(v1.vae, True))))

    # 5. encoder propagation on ppt-v1, FreeU
    reset_counts()
    cache = {}
    for n in CACHE_INTERVALS:
        box = {}
        ms = denoise_device_ms(pipe, lambda: box.setdefault("img", call(
            f"asym v1 encoder_cache_interval {n}", encoder_cache_interval=n, **kw)))
        cache[n] = dict(image=box["img"], ms=ms)
    check(np.array_equal(cache[1]["image"], outs["text-guided"]),
          "encoder_cache_interval 1: not the exact loop's image")
    for n in CACHE_INTERVALS[1:]:
        check(not np.array_equal(cache[n]["image"], cache[1]["image"]),
              f"encoder_cache_interval {n}: the image did not change")
        log(encoder_cache_interval=n, card=CARD[0], denoise_device_ms=cache[n]["ms"],
            denoise_device_ms_interval_1=cache[1]["ms"],
            device_ratio=(cache[n]["ms"] / cache[1]["ms"]
                          if cache[n]["ms"] and cache[1]["ms"] else None),
            psnr_vs_interval_1=psnr(cache[n]["image"], cache[1]["image"]))
    pipe.unet.freeu = FreeUConfig(*FREEU)
    box = {}
    ms = denoise_device_ms(pipe, lambda: box.setdefault("img", call(
        "asym v1 freeu", **kw)))
    pipe.unet.freeu = None
    check(not np.array_equal(box["img"], cache[1]["image"]),
          "freeu: the image did not change")
    log(freeu=list(FREEU), card=CARD[0], denoise_device_ms=ms,
        denoise_device_ms_off=cache[1]["ms"],
        psnr_vs_off=psnr(box["img"], cache[1]["image"]))
    path_done("encoder cache + freeu", v1_expected({"num_inference_steps": STEPS}))

    # 6. ControlNet refuses an encoder cache
    cn_cfg = ppt_v1_controlnet_config()
    with torch.device("meta"):
        branch = ControlNetModel(cn_cfg.controlnet)
    branch = _load(branch, random_state(branch, torch.Generator(device=device).manual_seed(1),
                                        device, torch.bfloat16),
                   device, torch.bfloat16, None)
    cn = ControlNetPipeline.from_pipeline(pipe, branch)
    edges = edge_map(HW, 3)
    try:
        cn(image, mask, edges, prompt=prompt, num_inference_steps=2,
           encoder_cache_interval=2)
        refused = None
    except TypeError as e:
        refused = str(e)
    check(refused is not None and "encoder_cache_interval" in refused,
          f"controlnet + encoder cache: {refused!r}")
    try:
        with torch.no_grad():
            pipe.unet(torch.zeros((2, 8, 8, 9), device=device), torch.tensor(1),
                      torch.zeros((2, 77, 768), device=device),
                      down_block_additional_residuals=[None] * 12,
                      emit_encoder_cache=True)
        unet_refused = None
    except ValueError as e:
        unet_refused = str(e)
    check(unet_refused is not None and "encoder caching" in unet_refused,
          f"unet + residuals + encoder cache: {unet_refused!r}")
    log(path="controlnet + encoder cache", refused=refused, unet_refused=unet_refused)
    del cn, branch, pipe, call, sd_vae
    torch.cuda.empty_cache()

    # 7. the BrushNet branch's cache on ppt-v2
    v2 = ppt_v2_config()
    state = init_state(v2, torch.Generator(device=device).manual_seed(0),
                       device=device, dtype=torch.bfloat16)
    pipe = BrushNetPipeline(v2, state, _tokenizer(v2), dtype=torch.bfloat16,
                            device=device)
    del state
    v2_expected = lambda kw: expected_launches_v2(  # noqa: E731
        v2, kw["num_inference_steps"],
        branch_cache_interval=kw.get("branch_cache_interval", 1))
    call = _caller(pipe, image, mask, v2_expected,
                   models=(("brushnet", "denoise_brushnet"),
                           ("unet", "denoise_base_unet")))
    call("v2 warm-up", prompt="a cat", seed=99, num_inference_steps=2)
    reset_counts()
    v2_rows = {}
    for n in (1, 2):
        box = {}
        ms = denoise_device_ms(pipe, lambda: box.setdefault("img", call(
            f"v2 branch_cache_interval {n}", branch_cache_interval=n, **kw)))
        v2_rows[n] = dict(image=box["img"], ms=ms)
    check(not np.array_equal(v2_rows[2]["image"], v2_rows[1]["image"]),
          "branch_cache_interval 2: the image did not change")
    log(branch_cache_interval=2, card=CARD[0], denoise_device_ms=v2_rows[2]["ms"],
        denoise_device_ms_interval_1=v2_rows[1]["ms"],
        device_ratio=(v2_rows[2]["ms"] / v2_rows[1]["ms"]
                      if v2_rows[2]["ms"] and v2_rows[1]["ms"] else None),
        psnr_vs_interval_1=psnr(v2_rows[2]["image"], v2_rows[1]["image"]))
    path_done("branch cache ppt-v2", v2_expected({"num_inference_steps": STEPS}))
    del pipe, call
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# phase 7g: the adapters
# ---------------------------------------------------------------------------

def ip_adapter_state(unet_cfg, dim: int, seed: int, device) -> dict:
    """A synthetic ip-adapter_sd15 checkpoint in the flat safetensors
    layout, fp16 values from a seed: the projection (4 tokens of the
    cross-attention width), lecun-scaled, live norm affines, and one
    ``to_k_ip`` / ``to_v_ip`` pair per attn2 (ids 1, 3, 5, ...)."""
    from powerpaint_tpu_torch.io.convert import ip_adapter_attn2_paths

    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape, scale=1.0, shift=0.0):
        x = torch.randn(shape, generator=g, device=device) * scale + shift
        return x.half()

    d, ch = unet_cfg.cross_attention_dim, unet_cfg.block_out_channels
    sd = {"image_proj.proj.weight": rnd(4 * d, dim, scale=dim ** -0.5),
          "image_proj.proj.bias": rnd(4 * d, scale=0.02),
          "image_proj.norm.weight": rnd(d, scale=0.1, shift=1.0),
          "image_proj.norm.bias": rnd(d, scale=0.1)}
    for idx, path in enumerate(ip_adapter_attn2_paths(unet_cfg)):
        kind, i = path.split(".")[:2]
        width = (ch[int(i)] if kind == "down_blocks" else
                 ch[::-1][int(i)] if kind == "up_blocks" else ch[-1])
        for name in ("to_k_ip", "to_v_ip"):
            sd[f"ip_adapter.{2 * idx + 1}.{name}.weight"] = rnd(
                width, d, scale=d ** -0.5)
    return sd


def expected_launches_ip(cfg, steps: int, adapters: int = 0,
                         images: int = 0) -> dict:
    """One ppt-v2 call with ``adapters`` IP-Adapters, ``images`` of whose
    embeddings the image tower encodes: ``expected_launches_v2``, and per
    base-UNet evaluation 16 image attentions (one per attn2) and one
    projection LayerNorm for each adapter; per encoded image the tower's
    LayerNorms (two a layer, the pre and the post one)."""
    from powerpaint_tpu_torch.io.convert import ip_adapter_attn2_paths

    out = expected_launches_v2(cfg, steps)
    n = evaluations(cfg, "unipc", steps)
    out["flash_attention"] += n * adapters * len(ip_adapter_attn2_paths(cfg.unet))
    layers = cfg.image_encoder.num_hidden_layers if images else 0
    out["layer_norm"] += n * adapters + images * (2 * layers + 2)
    return out


def _ip_counts(kw) -> tuple:
    """(adapters, encoded images) of a call's IP-Adapter arguments."""
    given = kw.get("ip_adapter_image")
    given = kw.get("ip_adapter_image_embeds") if given is None else given
    if given is None:
        return 0, 0
    n = len(given) if isinstance(given, (list, tuple)) else 1
    return n, n if kw.get("ip_adapter_image") is not None else 0


def run_adapter_path(device):
    """Phase 7g: the adapter models at full published width, bf16, random
    fp16-valued weights from seeds, 512^2, 20 UniPC steps, guidance 7.5.
    IP-Adapter on ppt-v2 (phase 7d's v2 stack, the ViT-H/14 tower, two
    ip-adapter_sd15 adapters): no adapter, an image twice (bitwise),
    embeddings (the image changes), scale 0 (bitwise the no-adapter image),
    two adapters with the second at 0 (bitwise the first alone), a
    two-request batch; seconds per image, the image encode's seconds, and
    the denoise loop's device ms by family with and without an adapter.
    The T2I-Adapter (SD1.5 full adapter) on a 512^2 map, then one CFG
    evaluation of the v2 base UNet with its four features (zero features
    bitwise no adapter; device ms). The stack written in fp16 as a v2
    directory with ``ip_adapter.safetensors`` and ``image_encoder/``,
    loaded (every tensor bitwise, the tower's config from its file) and one
    call bitwise the in-memory image. Launches exact per call."""
    import json as _json
    import os
    import shutil

    import powerpaint_tpu_torch
    from powerpaint_tpu_torch.core.config import (
        ppt_v2_config,
        vit_h14_image_encoder_config,
    )
    from powerpaint_tpu_torch.io import convert
    from powerpaint_tpu_torch.io.weights import build_annotator, random_state
    from powerpaint_tpu_torch.models.adapter import T2IAdapter
    from powerpaint_tpu_torch.models.layers import cast_compute
    from powerpaint_tpu_torch.pipelines.brushnet import BrushNetPipeline

    t0 = time.perf_counter()
    v2_cfg = ppt_v2_config()
    tower_cfg = vit_h14_image_encoder_config()
    cfg = v2_cfg.replace(
        unet=v2_cfg.unet.replace(ip_adapter_dim=tower_cfg.projection_dim,
                                 ip_adapter_tokens=(4, 4)),
        image_encoder=tower_cfg)
    state = _fp16_state(v2_cfg, device)
    base_unet = state["unet"]
    ip_files = [ip_adapter_state(cfg.unet, tower_cfg.projection_dim, seed, device)
                for seed in (1, 2)]
    unet = base_unet
    for a, ip_sd in enumerate(ip_files):
        unet = convert.merge_ip_adapter(
            unet, convert.convert_ip_adapter(ip_sd, cfg.unet, a))
    tower = {k: v.half() for k, v in random_state(
        build_annotator("clip_vision", tower_cfg),
        torch.Generator(device=device).manual_seed(3), device).items()}
    pipe = BrushNetPipeline(cfg, dict(state, unet=unet, image_encoder=tower),
                            _tokenizer(cfg), dtype=torch.bfloat16, device=device)
    del unet
    log(phase="setup", path="adapters",
        tower_params=sum(p.numel() for p in pipe.image_encoder.parameters()),
        ip_params_per_adapter=sum(v.numel() for v in ip_files[0].values()),
        seconds=time.perf_counter() - t0)

    image, mask = inputs(HW, 0)
    ref_image, _ = inputs((480, 640), 7)  # the IP reference image, resized
    prompt = "a red bench in a park"
    call = _caller(pipe, image, mask, lambda kw: expected_launches_ip(
        cfg, kw["num_inference_steps"], *_ip_counts(kw)),
        models=(("image_encoder", "ip_image_encode"),))
    call("adapters warm-up", prompt="a cat", seed=99, ip_adapter_image=ref_image)
    g = torch.Generator(device=device).manual_seed(4)
    e0, e1 = (torch.randn(tower_cfg.projection_dim, generator=g, device=device)
              for _ in range(2))

    reset_counts()  # the path starts here
    base = call("adapters no adapter", prompt=prompt, seed=1)
    base_s = call.seconds
    with_image = call("adapters ip image", prompt=prompt, seed=1,
                      ip_adapter_image=ref_image)
    image_s = call.seconds
    again = call("adapters ip image repeat", prompt=prompt, seed=1,
                 ip_adapter_image=ref_image)
    check(np.array_equal(again, with_image),
          "adapters: the same image and seed gave another image")
    one = call("adapters ip embeds", prompt=prompt, seed=1,
               ip_adapter_image_embeds=e0)
    d = np.abs(one.astype(np.int32) - base.astype(np.int32))
    log(call="adapters ip embeds", vs_no_adapter_max_uint8_diff=int(d.max()),
        vs_no_adapter_mean_uint8_diff=float(d.mean()))
    check(d.max() > 0, "adapters: the image embeddings did not change the image")
    zero = call("adapters ip scale 0", prompt=prompt, seed=1,
                ip_adapter_image_embeds=e0, ip_adapter_scale=0.0)
    d = np.abs(zero.astype(np.int32) - base.astype(np.int32))
    log(call="adapters ip scale 0", vs_no_adapter_max_uint8_diff=int(d.max()),
        bitwise=bool(d.max() == 0))
    check(d.max() == 0, "adapters: scale 0 is not the no-adapter image")
    stack = call("adapters two, second scale 0", prompt=prompt, seed=1,
                 ip_adapter_image_embeds=[e0, e1], ip_adapter_scale=[1.0, 0.0])
    check(np.array_equal(stack, one),
          "adapters: a stack with its second scale 0 is not the first alone")
    batch = call("adapters batch of two", prompt=[prompt, "a dog"], seed=[1, 5],
                 ip_adapter_image_embeds=e0)
    check(batch.shape == (2, HW, HW, 3), f"adapters batch output {batch.shape}")
    d = np.abs(batch[0].astype(np.int32) - one[0].astype(np.int32))
    log(path="adapters", batch_vs_standalone_max_uint8_diff=int(d.max()),
        batch_vs_standalone_mean_uint8_diff=float(d.mean()))
    encode_s = host_seconds(lambda: pipe._encode_one_ip_image(ref_image))
    families = {}, {}
    kw = dict(prompt=prompt, seed=1, num_inference_steps=STEPS,
              guidance_scale=GUIDANCE)
    no_ms = device_ms(lambda: pipe(image, mask, **kw), families[0])
    ip_ms = device_ms(lambda: pipe(image, mask, ip_adapter_image_embeds=e0, **kw),
                      families[1])
    log(path="adapters", card=CARD[0], no_adapter_seconds_per_image=base_s,
        ip_image_seconds_per_image=image_s, image_encode_seconds=encode_s,
        no_adapter_device_ms=no_ms, one_adapter_device_ms=ip_ms,
        adapter_device_ms_per_evaluation=(
            (ip_ms - no_ms) / evaluations(cfg, "unipc", STEPS)
            if no_ms and ip_ms else "not measured"),
        no_adapter_device_ms_by_family=families[0],
        one_adapter_device_ms_by_family=families[1])
    ip_launches = _path_counts("adapters ip", expected_launches_ip(cfg, STEPS, 2, 1))

    # ---- the T2I-Adapter and the UNet's intrablock features
    reset_counts()  # the T2I evaluation starts here
    with torch.device("meta"):  # the SD1.5 full adapter: the UNet's widths
        adapter = T2IAdapter(cfg.unet.block_out_channels)
    sd = random_state(adapter, torch.Generator(device=device).manual_seed(5),
                      device)
    adapter.load_state_dict(convert.convert_t2i_adapter(sd), assign=True)
    adapter = cast_compute(adapter.to(device), torch.bfloat16).to(
        memory_format=torch.channels_last).eval()
    gen = torch.Generator(device=device).manual_seed(6)
    cond = torch.rand(1, HW, HW, 3, generator=gen, device=device)
    sample = torch.randn(2, HW // 8, HW // 8, 4, generator=gen, device=device)
    context = torch.randn(2, 77, cfg.unet.cross_attention_dim, generator=gen,
                          device=device)
    t = torch.tensor(501, device=device)
    with torch.no_grad():
        feats = [f.repeat(2, 1, 1, 1) for f in adapter(cond)]  # the CFG pair
        check([tuple(f.shape) for f in feats] == [
            (2, HW // 8 >> i, HW // 8 >> i, c)
            for i, c in enumerate(cfg.unet.block_out_channels)],
            f"t2i features {[tuple(f.shape) for f in feats]}")
        before = read_counts()
        fed = pipe.unet(sample, t, context,
                        down_intrablock_additional_residuals=feats)
        after = read_counts()
        plain = pipe.unet(sample, t, context)
        zero = pipe.unet(sample, t, context,
                         down_intrablock_additional_residuals=[
                             torch.zeros_like(f) for f in feats])
        torch.cuda.synchronize()
    got = {k: after[k] - before[k] for k in after}
    want = _total((1, unet_launches(cfg.unet)))
    check(got == want, f"t2i evaluation: launches {got}, expected {want}")
    check(bool(torch.isfinite(fed).all()), "t2i evaluation: non-finite output")
    check(torch.equal(zero, plain), "t2i: zero features changed the output")
    d = float((fed.float() - plain.float()).abs().max())
    check(d > 0, "t2i: the features did not change the output")
    with torch.no_grad():
        # the adapter's few cuDNN launches: a CUDA graph of 20 calls (one
        # profiled call's device time varied 3x between runs)
        adapter_ms = graph_ms(lambda: adapter(cond))
        adapter_stream_ms = cuda_ms(lambda: adapter(cond))
        eval_ms = device_ms(lambda: pipe.unet(
            sample, t, context, down_intrablock_additional_residuals=feats))
        plain_ms = device_ms(lambda: pipe.unet(sample, t, context))
    log(path="adapters t2i", card=CARD[0],
        adapter_params=sum(p.numel() for p in adapter.parameters()),
        adapter_device_ms=adapter_ms, adapter_stream_ms=adapter_stream_ms,
        evaluation_device_ms=eval_ms, plain_evaluation_device_ms=plain_ms,
        launches=got, vs_no_features_max_abs_diff=d)
    t2i_launches = _path_counts("adapters t2i", want)
    del adapter, feats, fed, plain, zero

    # ---- the stack written as a v2 directory with the adapter's files
    work = os.path.join("smoke_out", "adapters")
    shutil.rmtree(work, ignore_errors=True)
    root = os.path.join(work, "ppt-v2")
    base_dir = os.path.join(root, "realisticVisionV60B1_v51VAE")
    bn_dir = os.path.join(root, "PowerPaint_Brushnet")
    enc_dir = os.path.join(root, "image_encoder")
    n_pos = (tower_cfg.image_size // tower_cfg.patch_size) ** 2 + 1
    files = {
        os.path.join(base_dir, "unet", "diffusion_pytorch_model.safetensors"):
            base_unet,
        os.path.join(base_dir, "vae", "diffusion_pytorch_model.safetensors"):
            state["vae"],
        os.path.join(base_dir, "text_encoder", "model.safetensors"):
            _with_position_ids(state["text_encoder"]),
        os.path.join(bn_dir, "diffusion_pytorch_model.safetensors"):
            state["brushnet"],
        os.path.join(bn_dir, "pytorch_model.bin"):
            _with_position_ids(state["text_encoder_brushnet"]),
        os.path.join(root, "ip_adapter.safetensors"): ip_files[0],
        os.path.join(enc_dir, "model.safetensors"): {
            **tower, "vision_model.embeddings.position_ids":
                torch.arange(n_pos)[None]}}
    t0 = time.perf_counter()
    nbytes = sum(_write(path, sd) for path, sd in files.items())
    with open(os.path.join(enc_dir, "config.json"), "w", encoding="utf-8") as f:
        _json.dump(tower_cfg.to_dict(), f)  # the published config.json's keys
    write_s = time.perf_counter() - t0
    del state, base_unet, tower, files
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loaded = powerpaint_tpu_torch.load(root, "ppt-v2").pipeline
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    log(checkpoint="adapters ppt-v2", card=CARD[0], bytes=nbytes,
        write_seconds=write_s, load_seconds=load_s,
        load_gb_per_s=nbytes / load_s / 1e9,
        image_encoder=loaded.config.image_encoder.to_dict(),
        ip_adapter=[loaded.config.unet.ip_adapter_dim,
                    loaded.config.unet.ip_adapter_tokens])
    check(loaded.config.image_encoder == tower_cfg,
          f"adapters load: tower config {loaded.config.image_encoder}")
    check((loaded.config.unet.ip_adapter_dim, loaded.config.unet.ip_adapter_tokens)
          == (tower_cfg.projection_dim, 4),
          "adapters load: not one adapter of the tower's width -> 4 tokens")
    for f in ("vae", "text_encoder", "brushnet", "text_encoder_brushnet",
              "image_encoder"):
        _same_weights(f"adapters load {f}", getattr(loaded, f), getattr(pipe, f))
    mine, ref = loaded.unet.state_dict(), pipe.unet.state_dict()
    bad = [k for k in mine if k not in ref or not torch.equal(mine[k], ref[k])]
    check(not bad, f"adapters load unet: {len(bad)} tensors differ, e.g. {bad[:3]}")
    check(len(ref) - len(mine) == 4 + 32,
          f"adapters load unet: {len(ref) - len(mine)} tensors short of the stack")
    del pipe, call
    torch.cuda.empty_cache()
    call = _caller(loaded, image, mask, lambda kw: expected_launches_ip(
        cfg, kw["num_inference_steps"], *_ip_counts(kw)))
    reset_counts()  # the loaded stack's call starts here
    got = call("adapters loaded ip image", prompt=prompt, seed=1,
               ip_adapter_image=ref_image)
    check(np.array_equal(got, with_image),
          "adapters load: the image is not the in-memory stack's")
    load_launches = _path_counts("adapters loaded", expected_launches_ip(
        cfg, STEPS, 1, 1))
    del loaded, call
    shutil.rmtree(work)
    torch.cuda.empty_cache()
    return {k: ip_launches[k] + t2i_launches[k] + load_launches[k]
            for k in ip_launches}


# ---------------------------------------------------------------------------
# phase 7h: serving
# ---------------------------------------------------------------------------

# extra options of the two cold-start processes (a rehearsal on the CPU
# sets ("--tiny", "--device", "cpu"))
COLD_START_ARGS = ()
SERVE_PROMPT = "a red bench in a park"


def sync_free_submit(pipe, image, mask, **kw):
    """``pipe.submit`` under ``torch.cuda.set_sync_debug_mode("error")``:
    any synchronising call between the call's entry and its final copy
    raises. Returns (pending, seconds until submit() returned)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    try:
        pending = pipe.submit(image, mask, **kw)
    except RuntimeError as e:
        fail(f"submit() synchronised with the card: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return pending, time.perf_counter() - t0


def _png_b64(array) -> str:
    import base64
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(array).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _decode_png(body: bytes) -> np.ndarray:
    import io

    from PIL import Image

    with Image.open(io.BytesIO(body)) as im:
        return np.asarray(im.convert("RGB"))


def _http(url: str, payload=None, timeout: float = 300.0):
    """(status, content type, body) of a GET, or of a POST of ``payload``
    as JSON; an HTTP error is a result, not an exception."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        try:
            return e.code, e.headers["Content-Type"], e.read()
        finally:
            e.close()


def serve_payload(image, mask, seed: int, prompt: str = SERVE_PROMPT) -> dict:
    """Phase 3's request as ``POST /inpaint`` fields: the image and mask as
    PNGs, 20 steps, guidance 7.5, at its own size."""
    h, w = image.shape[:2]
    return dict(image_b64=_png_b64(image),
                mask_b64=_png_b64((mask * 255).astype(np.uint8)),
                prompt=prompt, steps=STEPS, guidance_scale=GUIDANCE, seed=seed,
                short_side=min(h, w))


class _InProcessServer:
    """``serve.app.make_server`` on a free port, serving in a thread."""

    def __init__(self, pipe, **kw):
        import threading

        from powerpaint_tpu_torch.serve.app import make_server

        self.server = make_server(pipe, port=0, **kw)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(60)

    def post(self, payload):
        return _http(self.url + "/inpaint", payload)


def _concurrent(fn, args) -> list:
    """``fn(a)`` for each of ``args`` in a thread each, all started
    together; their results in order."""
    import threading

    out = [None] * len(args)

    def run(i):
        try:
            out[i] = fn(args[i])
        except Exception as e:  # reported by the check below
            out[i] = e

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(len(args))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    for r in out:
        check(r is not None and not isinstance(r, Exception),
              f"a concurrent request failed: {r!r}")
    return out


def _port_copy(root: str) -> str:
    """A fresh copy of ``powerpaint_tpu_torch/`` (without ``_build/``) and
    ``native/`` under ``root``."""
    import os
    import shutil

    if os.path.exists(root):
        shutil.rmtree(root)
    os.makedirs(root)
    shutil.copytree("powerpaint_tpu_torch",
                    os.path.join(root, "powerpaint_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copytree("native", os.path.join(root, "native"),
                    ignore=shutil.ignore_patterns("*.so", "*.o"))
    return os.path.abspath(root)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cold_start(work: str, image, mask) -> None:
    """(a) The one-shot command in a fresh copy of the port: it builds
    every kernel it runs and dumps ``--aot-cache``. (b) ``--serve
    --micro-batch 4 --aot-cache`` in another fresh copy: it installs the
    file's kernels (no nvcc), answers ``/health``, then (a)'s request
    bitwise (a)'s image. Each process's seconds from its start to its
    first image."""
    import glob
    import os

    from PIL import Image

    os.makedirs(work, exist_ok=True)
    cache = os.path.abspath(os.path.join(work, "kernels.aot"))
    if os.path.exists(cache):
        os.remove(cache)
    paths = {k: os.path.abspath(os.path.join(work, f"{k}.png"))
             for k in ("image", "mask", "oneshot")}
    Image.fromarray(image).save(paths["image"])
    Image.fromarray((mask * 255).astype(np.uint8)).save(paths["mask"])
    module = [sys.executable, "-m", "powerpaint_tpu_torch.serve.cli",
              *COLD_START_ARGS]

    a = _port_copy(os.path.join(work, "a"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        module + ["--image", paths["image"], "--mask", paths["mask"],
                  "--output", paths["oneshot"], "--prompt", SERVE_PROMPT,
                  "--steps", str(STEPS), "--short_side", str(image.shape[0]),
                  "--seed", "1", "--aot-cache", cache],
        cwd=a, capture_output=True, text=True, timeout=600)
    a_s = time.perf_counter() - t0
    nvcc_logs = sorted(os.path.basename(p) for p in
                       glob.glob(os.path.join(a, "powerpaint_tpu_torch",
                                              "_build", "*.log")))
    log(serving="cold start (a) one-shot", rc=proc.returncode,
        seconds_to_first_image=a_s, stdout=proc.stdout.strip().splitlines(),
        stderr_tail=proc.stderr.strip().splitlines()[-5:],
        nvcc_logs=nvcc_logs, cache_bytes=(os.path.getsize(cache)
                                          if os.path.exists(cache) else None))
    check(proc.returncode == 0, f"cold start (a): exit {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    check(f"aot: dumped {cache}" in proc.stdout,
          f"cold start (a) did not dump the cache: {proc.stdout!r}")
    with Image.open(paths["oneshot"]) as im:
        oneshot = np.asarray(im.convert("RGB"))

    b = _port_copy(os.path.join(work, "b"))
    port = _free_port()
    out_path, err_path = (os.path.join(work, f"serve.{k}") for k in ("out", "err"))
    with open(out_path, "w") as out, open(err_path, "w") as err:
        t0 = time.perf_counter()
        server = subprocess.Popen(
            module + ["--serve", "--micro-batch", "4", "--aot-cache", cache,
                      "--port", str(port)],
            cwd=b, stdout=out, stderr=err, text=True)
        try:
            url = f"http://127.0.0.1:{port}"
            health = None
            while time.perf_counter() - t0 < 300 and server.poll() is None:
                try:
                    health = _http(url + "/health", timeout=5)
                    break
                except OSError:
                    time.sleep(0.25)
            health_s = time.perf_counter() - t0
            check(health is not None and health[0] == 200,
                  f"cold start (b): no /health (exit {server.poll()}): "
                  f"{open(err_path).read()[-2000:]}")
            status, ctype, body = _http(url + "/inpaint",
                                        serve_payload(image, mask, 1))
            b_s = time.perf_counter() - t0
        finally:
            server.terminate()
            try:
                server.wait(30)
            except subprocess.TimeoutExpired:
                server.kill()
                server.wait(30)
    printed = open(out_path).read()
    b_logs = sorted(os.path.basename(p) for p in
                    glob.glob(os.path.join(b, "powerpaint_tpu_torch",
                                           "_build", "*.log")))
    installed = sorted(os.path.basename(p) for p in
                       glob.glob(os.path.join(b, "powerpaint_tpu_torch",
                                              "_build", "*.so")))
    log(serving="cold start (b) server", status=status,
        seconds_to_health=health_s, seconds_to_first_image=b_s,
        stdout=printed.strip().splitlines(),
        stderr_tail=open(err_path).read().strip().splitlines()[-5:],
        nvcc_logs=b_logs, libraries=installed,
        seconds_to_first_image_one_shot=a_s)
    check(status == 200 and ctype == "image/png",
          f"cold start (b): {status} {body[:300]!r}")
    check(f"aot: loaded {cache}" in printed,
          f"cold start (b) did not load the cache: {printed!r}")
    check(not b_logs, f"cold start (b) ran nvcc: {b_logs}")
    check(np.array_equal(_decode_png(body), oneshot),
          "cold start (b): the served image is not the one-shot image")


def run_serving_path(device, v1_refs: dict):
    """Phase 7h: serving at full width, bf16, 512^2, 20 steps. ``submit()``
    under ``set_sync_debug_mode("error")`` on ppt-v1 DDIM (bitwise phase
    3's image), ppt-v1 euler_a, ppt-v2 UniPC and ppt-v1 + ControlNet, each
    result bitwise its ``__call__``; ``serve.app.make_server`` in this
    process, one request at a time (``/health``, phase 3's request bitwise
    its blended image, a 400) and micro-batched (four concurrent requests
    as one batch of 4 within Queue C's batch-vs-alone bound; eight at once
    against eight one by one); the cold start through the cache in two
    processes (``cold_start``)."""
    import os

    from powerpaint_tpu_torch.core.config import (
        ppt_v1_config,
        ppt_v1_controlnet_config,
        ppt_v2_config,
    )
    from powerpaint_tpu_torch.io.weights import init_state
    from powerpaint_tpu_torch.pipelines.brushnet import BrushNetPipeline
    from powerpaint_tpu_torch.pipelines.controlnet import ControlNetPipeline
    from powerpaint_tpu_torch.pipelines.inpaint import InpaintPipeline
    from powerpaint_tpu_torch.tasks.postprocess import blend_result

    def stack(cls, cfg):
        state = init_state(cfg, torch.Generator(device=device).manual_seed(0),
                           device=device, dtype=torch.bfloat16)
        return cls(cfg, state, _tokenizer(cfg), dtype=torch.bfloat16,
                   device=device)

    cfg, cfg2, cfgc = ppt_v1_config(), ppt_v2_config(), ppt_v1_controlnet_config()
    t0 = time.perf_counter()
    pipe = stack(InpaintPipeline, cfg)
    log(phase="setup", path="serving", card=CARD[0],
        seconds=time.perf_counter() - t0)
    image, mask = inputs(HW, 0)
    edges = edge_map(HW, 0)
    base = dict(prompt=SERVE_PROMPT, seed=1, num_inference_steps=STEPS,
                guidance_scale=GUIDANCE)
    total = {k: 0 for k in KERNELS}

    def counted(label, want, run):
        """``run()`` with its launches checked against ``want``."""
        before = read_counts()
        out = run()
        got = {k: v - before[k] for k, v in read_counts().items()}
        check(got == want, f"{label}: launches {got}, expected {want}")
        for k, n in got.items():
            total[k] += n
        return out

    # ---- submit() never waits on the card
    cases = (("ppt-v1 ddim", lambda: pipe, {}, expected_launches(cfg, STEPS)),
             ("ppt-v1 euler_a", lambda: pipe, dict(scheduler="euler_a"),
              expected_launches(cfg, STEPS, scheduler="euler_a")),
             ("ppt-v2 unipc", lambda: stack(BrushNetPipeline, cfg2), {},
              expected_launches_v2(cfg2, STEPS)),
             ("ppt-v1 + controlnet", lambda: stack(ControlNetPipeline, cfgc),
              dict(control_image=edges), expected_launches_cn(cfgc, STEPS)))
    for label, make, extra, want in cases:
        p = make()
        kw = dict(base, **extra)
        p(image, mask, **kw)  # warm-up: the plans of this stack's shapes
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = counted(f"serving {label} __call__", want, lambda: p(image, mask, **kw))
        call_s = time.perf_counter() - t0

        def submitted():
            pending, submit_s = sync_free_submit(p, image, mask, **kw)
            out = pending.result()
            return out, submit_s, time.perf_counter() - t0

        t0 = time.perf_counter()
        out, submit_s, result_s = counted(f"serving {label} submit", want, submitted)
        log(serving=label, card=CARD[0], submit_return_s=submit_s,
            result_return_s=result_s, call_wall_s=call_s, sync_free=True)
        check(np.array_equal(out, ref),
              f"serving {label}: submit().result() is not the __call__ image")
        if label == "ppt-v1 ddim":
            check(np.array_equal(out, v1_refs["text-guided"]),
                  "serving ppt-v1: submit() is not phase 3's image")
        if p is not pipe:
            del p
            torch.cuda.empty_cache()

    # ---- HTTP, one request at a time
    want = expected_launches(cfg, STEPS)
    payload = serve_payload(image, mask, 1)
    with _InProcessServer(pipe) as s:
        check(_http(s.url + "/health")[:2] == (200, "application/json"),
              "serving: /health")
        t0 = time.perf_counter()
        status, ctype, body = counted("serving POST", want, lambda: s.post(payload))
        log(serving="POST /inpaint", status=status, content_type=ctype,
            seconds=time.perf_counter() - t0, png_bytes=len(body))
        check((status, ctype) == (200, "image/png"), f"serving POST: {status}")
        check(np.array_equal(_decode_png(body), blend_result(
            v1_refs["text-guided"][0], image, mask)),
            "serving POST: the PNG is not phase 3's blended image")
        bad = s.post(dict(payload, task="bogus"))
        log(serving="POST bad field", status=bad[0], body=bad[2].decode()[:200])
        check(bad[0] == 400, f"serving: a bad field got {bad[0]}")

    # ---- HTTP, micro-batched
    import threading

    four = [(11, "a dog"), (12, "a cat on a sofa"), (13, "a bowl of fruit"),
            (14, "a lighthouse")]
    alone = [blend_result(pipe(image, mask, prompt=p_, seed=s_,
                               num_inference_steps=STEPS,
                               guidance_scale=GUIDANCE)[0], image, mask)
             for s_, p_ in four]
    with _InProcessServer(pipe, micro_batch=4) as s:
        batcher = s.server.batcher
        entered, real_submit = threading.Event(), pipe.submit

        def gated(*a, **kw):
            """The first dispatch waits until the four are queued: they
            arrive while it runs."""
            if not entered.is_set():
                entered.set()
                deadline = time.monotonic() + 120
                while batcher._q.qsize() < 4 and time.monotonic() < deadline:
                    time.sleep(0.002)
            return real_submit(*a, **kw)

        pipe.submit = gated
        try:
            def burst():
                first = threading.Thread(
                    target=lambda: s.post(serve_payload(image, mask, 10)),
                    daemon=True)
                first.start()
                check(entered.wait(120), "serving: the first request never ran")
                out = _concurrent(s.post, [serve_payload(image, mask, s_, p_)
                                           for s_, p_ in four])
                first.join(600)
                return out

            out = counted("serving micro-batch 1 + 4", _total((2, want)), burst)
        finally:
            del pipe.submit
        sizes = dict(batcher.sizes)
        check(sizes == {1: 1, 4: 1}, f"serving: batches {sizes}, not 1 and 4")
        for (s_, p_), (status, _, body), ref in zip(four, out, alone):
            check(status == 200, f"serving micro-batch: {status}")
            d = np.abs(_decode_png(body).astype(np.int32) - ref.astype(np.int32))
            log(serving="micro-batch of 4 vs alone", seed=s_,
                max_uint8_diff=int(d.max()), mean_uint8_diff=float(d.mean()))
            check(d.max() <= V1_BATCH_MAX_UINT8 and d.mean() <= V1_BATCH_MEAN_UINT8,
                  f"serving micro-batch: seed {s_} is {d.max()} / {d.mean()} "
                  "from its request alone")

        eight = [serve_payload(image, mask, 20 + i, f"request {i}") for i in range(8)]
        batcher.sizes.clear()
        t0 = time.perf_counter()
        for p_ in eight:
            check(s.post(p_)[0] == 200, "serving: a serial request failed")
        serial_s = time.perf_counter() - t0
        batcher.sizes.clear()
        t0 = time.perf_counter()
        outs = _concurrent(s.post, eight)
        burst_s = time.perf_counter() - t0
        check(all(o[0] == 200 for o in outs), "serving: a burst request failed")
        log(serving="eight requests", card=CARD[0],
            serial_s=serial_s, serial_images_per_s=8 / serial_s,
            micro_batch_s=burst_s, micro_batch_images_per_s=8 / burst_s,
            micro_batch_sizes=dict(batcher.sizes))
    del pipe
    torch.cuda.empty_cache()

    # ---- the cold start, in two processes
    cold_start(os.path.join("smoke_out", "serving"), image, mask)
    return total


# device time by family, from the kernel names (first match wins); the
# GroupNorm family holds the statistics launches of the fused conv and the
# int8 units' quantisers too
FAMILIES = (("flash_attention", ("flash_",)),
            ("conv3x3 kernel", ("conv3x3_kernel", "conv3x3_bf16_kernel")),
            ("conv3x3 int8 kernel", ("conv3x3_int8_kernel",)),
            ("group_norm", ("gn_resident_kernel", "gn_partial_kernel",
                            "gn_finish_kernel", "quantize_kernel")),
            ("layer_norm", ("ln_kernel",)),
            ("cudnn conv", ("fprop", "conv", "dgrad", "wgrad")),
            ("matmul", ("gemm", "nvjet", "cutlass")))


def by_family(kernels) -> dict:
    """{family: device ms} of (name, device us, count) rows."""
    out = {}
    for name, t, _ in kernels:
        fam = next((f for f, keys in FAMILIES if any(k in name for k in keys)),
                   "other")
        out[fam] = out.get(fam, 0.0) + t / 1e3
    return out

def profile_call(label: str, run_call) -> None:
    """One 20-step call under ``torch.profiler``: device time by kernel
    family and the top kernels, and the device's busy share of the call's
    wall time, against the profiled call and against the same call
    unprofiled (the profiler slows the host side). Every profiled call of
    the script records the card's activity alone (CUPTI's kernel records,
    of which the device times are made): recording each CPU op as well cost
    15-35 s of the profiler's own processing a 20-step call, about a third
    of the script's time."""
    from torch.profiler import ProfilerActivity, profile

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_call()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e6

    plain_wall_us = run()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    log(profile=label, steps=STEPS, device_ms_by_family=by_family(kernels),
        wall_ms=wall_us / 1e3, unprofiled_wall_ms=plain_wall_us / 1e3,
        device_busy_ms=busy_us / 1e3, device_busy_share=busy_us / wall_us,
        device_busy_share_unprofiled=busy_us / plain_wall_us,
        top_kernels=[dict(name=n[:90], ms=t / 1e3, calls=c, share=t / busy_us)
                     for n, t, c in kernels[:12]])


def tiny_reference(device) -> None:
    """The tiny ppt-v1, ppt-v2 and ppt-v1 + ControlNet configurations, fp32,
    each at its default sampler and at one other (and ppt-v1 with the
    asymmetric VAE, encoder propagation and FreeU, ppt-v2 with the branch's
    cache, ppt-v2 with two IP-Adapters on the tiny image tower), through
    the kernels on the card and through the plain versions
    on the CPU, with the same weights and the same noise (the step noise
    too): the uint8 images must agree within the JAX package's end-to-end
    bound (max 3, mean 0.5).

    ppt-v1 with int8 on (every ResNet unit is an int8 site at this size) is
    held site by site instead: static-scale quantisation turns an fp32 ulp
    of difference anywhere upstream into a whole int8 level wherever a value
    sits at a rounding boundary, and the flips compound over the layers, so
    two right implementations need not give close images. Each int8 unit of
    the card's call is recomputed by the plain version on the CPU from the
    input the card gave it, within ``int8_check``'s flip bound; the images'
    difference is logged."""
    from powerpaint_tpu_torch import schedulers
    from powerpaint_tpu_torch.models.layers import Conv2D
    from powerpaint_tpu_torch.ops import conv
    from powerpaint_tpu_torch.io.weights import init_state
    from powerpaint_tpu_torch.pipelines.common import per_iteration
    from powerpaint_tpu_torch.pipelines.brushnet import (
        BrushNetPipeline,
        cond_scale_table,
    )
    from powerpaint_tpu_torch.pipelines.controlnet import (
        ControlNetPipeline,
        gating_table,
    )
    from powerpaint_tpu_torch.pipelines.inpaint import InpaintPipeline
    from powerpaint_tpu_torch.ops.freeu import FreeUConfig
    from powerpaint_tpu_torch.testing import (
        tiny_asymmetric_vae,
        tiny_clip_vision_config,
        tiny_v1_config,
        tiny_v1_controlnet_config,
        tiny_v2_config,
    )
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

    def v1(pipe, dev, noise, steps=3, kept=3, step_noise=None, **extra):
        ids = pipe.encode_task(add_task("a dog", "", "text-guided"))[None]
        return pipe._generate(
            torch.as_tensor(ids, dtype=torch.long, device=dev),
            torch.tensor([0.6], device=dev), torch.as_tensor(image[None], device=dev),
            torch.as_tensor(mask_u8, device=dev), torch.tensor([7.5], device=dev),
            *noise[:3], step_noise, num_steps=steps, strength_steps=kept,
            output_type="uint8", **extra)

    def cn(pipe, dev, noise, scheduler="ddim", window=(0.0, 1.0)):
        control = torch.as_tensor(edge_map(64, 2)[None, None], device=dev)
        mod, _ = schedulers.get(scheduler)
        table = per_iteration(mod, gating_table(3, [1.0], [window[0]],
                                                [window[1]]))
        return v1(pipe, dev, noise, control_u8=control, scales=table,
                  scheduler=scheduler)

    def v2(pipe, dev, noise, steps=3, scheduler="unipc", step_noise=None,
           **extra):
        task = "object-removal"
        ids_t, ids_u = pipe.encode_task(
            add_task(v2_prompt_suffix("a dog", task), "", task, "ppt-v2"))
        return pipe._generate(
            torch.as_tensor(ids_t[None], dtype=torch.long, device=dev),
            torch.as_tensor(ids_u[None], dtype=torch.long, device=dev),
            torch.tensor([0.6], device=dev), torch.as_tensor(image[None], device=dev),
            torch.as_tensor(mask_u8, device=dev), torch.tensor([7.5], device=dev),
            cond_scale_table(steps, 1.0, 0.0, 1.0), *noise[:2], step_noise,
            num_steps=steps, output_type="uint8", scheduler=scheduler, **extra)

    def v1_cached_freeu(pipe, dev, noise):
        # the asymmetric decode, encoder propagation (key steps 0 and 2 of
        # 4) and FreeU in one call
        pipe.unet.freeu = FreeUConfig(*FREEU)
        return v1(pipe, dev, noise, steps=4, kept=4, encoder_cache_interval=2)

    # one sampler per pipeline beside the defaults: euler_a at strength 0.6
    # (3 of 5 steps, sigma space, step noise), LCM on an LCM UNet (the
    # guidance embedding, step noise), heun with a window (39 -> 5 rows)
    tiny_lcm = tiny_v2_config().replace(
        unet=tiny_v2_config().unet.replace(time_cond_proj_dim=8))
    # two IP-Adapters on the tiny tower, each given its own image
    tower = tiny_clip_vision_config()
    tiny_ip = tiny_v2_config().replace(
        unet=tiny_v2_config().unet.replace(
            ip_adapter_dim=tower.projection_dim, ip_adapter_tokens=(4, 4)),
        image_encoder=tower)
    ip_images = [image, np.ascontiguousarray(image[::-1])]
    for label, cfg, cls, gen, int8 in (
            ("ppt-v1", tiny_v1_config(), InpaintPipeline, v1, False),
            ("ppt-v2", tiny_v2_config(), BrushNetPipeline, v2, False),
            ("ppt-v1 + controlnet", tiny_v1_controlnet_config(),
             ControlNetPipeline, cn, False),
            ("ppt-v1 euler_a strength 0.6", tiny_v1_config(), InpaintPipeline,
             lambda p, d, n: v1(p, d, n, steps=5, kept=3, step_noise=n[3:6],
                                scheduler="euler_a"), False),
            ("ppt-v2 lcm unet", tiny_lcm, BrushNetPipeline,
             lambda p, d, n: v2(p, d, n, steps=4, scheduler="lcm",
                                step_noise=n[3:7]), False),
            ("ppt-v1 + controlnet heun", tiny_v1_controlnet_config(),
             ControlNetPipeline,
             lambda p, d, n: cn(p, d, n, "heun", (0.1, 0.6)), False),
            ("ppt-v1 int8", tiny_v1_config(), InpaintPipeline, v1, True),
            ("ppt-v1 asymmetric, encoder cache 2, freeu",
             tiny_v1_config().replace(vae=tiny_asymmetric_vae()), InpaintPipeline,
             v1_cached_freeu, False),
            ("ppt-v2 branch cache 2", tiny_v2_config(), BrushNetPipeline,
             lambda p, d, n: v2(p, d, n, steps=4, branch_cache_interval=2), False),
            ("ppt-v2 two ip-adapters", tiny_ip, BrushNetPipeline,
             lambda p, d, n: v2(p, d, n, ip_embeds=p._ip_pairs(ip_images, None, 1),
                                ip_scale=[0.7, 1.3]), False)):
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
            noise = [torch.randn((1, 8, 8, 4), generator=g).to(dev) for _ in range(7)]
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

    # a served request (``serve.app._run_request``: the decode, the pipeline
    # call, the blend and the PNG) on the tiny ppt-v1 pipeline; the card's
    # pipeline draws its noise on the CPU, so both sides see the same draws
    from powerpaint_tpu_torch.serve.app import _run_request

    cfg = tiny_v1_config()
    state = init_state(cfg, torch.Generator().manual_seed(0), device="cpu",
                       dtype=torch.float32)
    pipes = {d: InpaintPipeline(cfg, state, tok, dtype=torch.float32, device=d)
             for d in ("cpu", device)}
    on_cpu = pipes["cpu"]._draw_noise
    pipes[device]._draw_noise = lambda *a: [
        x if x is None else x.to(device) if torch.is_tensor(x)
        else [y.to(device) for y in x] for x in on_cpu(*a)]
    payload = dict(serve_payload(image, mask, 3), steps=3)
    outs = {d: _decode_png(_run_request(p, payload)[1]).astype(np.int32)
            for d, p in pipes.items()}
    d = np.abs(outs["cpu"] - outs[device])
    log(tiny_reference="served request ppt-v1", max_uint8_diff=int(d.max()),
        mean_uint8_diff=float(d.mean()))
    check(d.max() <= 3 and d.mean() <= 0.5,
          f"tiny served request: card vs CPU uint8 diff max {d.max()} mean {d.mean()}")
    torch.backends.cudnn.allow_tf32 = True


# ---------------------------------------------------------------------------
# phase 2 (gradients), phase 7i (training) and phase 8 (tiny training)
# ---------------------------------------------------------------------------

# The kernels' Functions at the shapes a full-width v1 train step at 512^2
# gives them (batch 2, bf16): flash self-attention at the first two levels
# and the cross-attention to 77 tokens; the ResNet unit at the first and
# the deepest level; the last upsampler's conv; GroupNorm as a transformer's
# input norm and as conv_norm_out (+SiLU); LayerNorm in a transformer block
# and in CLIP.
GRAD_SHAPES = {
    "flash_attention": [(2, 4096, 4096, 8, 40), (2, 1024, 1024, 8, 80),
                        (2, 4096, 77, 8, 40)],
    "conv3x3_gn_silu": [(2, 64, 64, 320, 320, 32), (2, 8, 8, 1280, 1280, 32)],
    "conv3x3": [(2, 64, 64, 640, 640, 0)],
    "group_norm": [((2, 4096, 320), 1e-6, False), ((2, 4096, 320), 1e-5, True)],
    "layer_norm": [((2, 4096, 320), 1e-5), ((2, 77, 768), 1e-5)],
}
GRAD_FUNCTIONS = {"flash_attention": "FlashAttentionBackward",
                  "conv3x3_gn_silu": "Conv3x3GnSiluBackward",
                  "conv3x3": "Conv3x3Backward", "group_norm": "GroupNormBackward",
                  "layer_norm": "LayerNormBackward"}


def grad_checks(device) -> dict:
    """Each kernel's ``torch.autograd.Function`` on the card: its output
    has the Function's ``grad_fn`` (a wrapper that filled a fresh tensor
    through ctypes without one would cut every gradient upstream), its
    forward is the kernel's (within ``tolerance`` of the plain version, as
    in the checks above), and its gradients, a recompute of the plain
    version on the saved inputs, against autograd of the plain version on
    the same inputs and the same output gradient: the same arithmetic, so
    bitwise but for a nondeterministic cuDNN or cuBLAS backward, bound one
    bf16 step of each input's largest gradient. Returns {kernel: max
    |err|}."""
    from powerpaint_tpu_torch.ops import conv, norms
    from powerpaint_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(4321)
    bf, f32 = torch.bfloat16, torch.float32

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)

    def cases():
        for (b, sq, skv, n, d) in GRAD_SHAPES["flash_attention"]:
            yield ("flash_attention", (b, sq, skv, n, d),
                   [randn(b, sq, n, d), randn(b, skv, n, d), randn(b, skv, n, d)],
                   lambda q, k, v: fa.flash_attention(q, k, v),
                   lambda q, k, v: fa.flash_attention_plain(q, k, v))
        for name in ("conv3x3_gn_silu", "conv3x3"):
            for (b, h, w, cin, cout, groups) in GRAD_SHAPES[name]:
                x = randn(b, h, w, cin, scale=2.0)
                wt = randn(cout, cin, 3, 3, scale=1 / (3 * cin ** 0.5)).contiguous(
                    memory_format=torch.channels_last)
                bias = randn(cout, scale=0.1)
                if name == "conv3x3":
                    yield (name, (b, h, w, cin, cout), [x, wt, bias],
                           conv.conv3x3, conv.conv3x3_plain)
                    continue
                kw = dict(num_groups=groups, eps=1e-5)
                yield (name, (b, h, w, cin, cout),
                       [x, wt, bias, 1 + randn(cin, scale=0.1, dtype=f32),
                        randn(cin, scale=0.1, dtype=f32)],
                       lambda *a, kw=kw: conv.conv3x3_gn_silu(*a, **kw),
                       lambda *a, kw=kw: conv.conv3x3_gn_silu_plain(*a, **kw))
        for shape, eps, silu in GRAD_SHAPES["group_norm"]:
            kw = dict(num_groups=32, eps=eps, silu=silu)
            c = shape[-1]
            yield ("group_norm", shape,
                   [randn(*shape, scale=2.0), 1 + randn(c, scale=0.1, dtype=f32),
                    randn(c, scale=0.1, dtype=f32)],
                   lambda *a, kw=kw: norms.group_norm(*a, **kw),
                   lambda *a, kw=kw: norms.group_norm_plain(*a, **kw))
        for shape, eps in GRAD_SHAPES["layer_norm"]:
            c = shape[-1]
            yield ("layer_norm", shape,
                   [randn(*shape, scale=3.0), 1 + randn(c, scale=0.1, dtype=f32),
                    randn(c, scale=0.1, dtype=f32)],
                   lambda *a, eps=eps: norms.layer_norm(*a, eps=eps),
                   lambda *a, eps=eps: norms.layer_norm_plain(*a, eps=eps))

    t0 = time.perf_counter()
    worst = {}
    for name, shape, inputs_, fn, plain in cases():
        leaves = [t.detach().requires_grad_(True) for t in inputs_]
        refs = [t.detach().requires_grad_(True) for t in inputs_]
        out = fn(*leaves)
        fn_name = type(out.grad_fn).__name__ if out.grad_fn is not None else None
        check(fn_name == GRAD_FUNCTIONS[name],
              f"{name} {shape}: output grad_fn {fn_name}, not "
              f"{GRAD_FUNCTIONS[name]}")
        want = plain(*refs)
        fwd_err = float((out.float() - want.float()).abs().max())
        check(fwd_err <= tolerance(bf, want),
              f"{name} {shape}: forward |err| {fwd_err}")
        g = torch.randn(out.shape, generator=gen, device=device).to(out.dtype)
        got = torch.autograd.grad(out, leaves, g)
        ref = torch.autograd.grad(want, refs, g)
        torch.cuda.synchronize()
        errs = [float((a.float() - r.float()).abs().max())
                for a, r in zip(got, ref)]
        bounds = [2.0 ** -7 * float(r.float().abs().max()) for r in ref]
        err = max(errs)
        log(check=f"{name} gradient", shape=list(shape), dtype="bfloat16",
            grad_fn=fn_name, forward_max_abs_err=fwd_err, max_abs_err=errs,
            bound=bounds, bitwise=all(torch.equal(a, r) for a, r in zip(got, ref)))
        check(all(e <= b for e, b in zip(errs, bounds)),
              f"{name} {shape}: gradient |err| {errs} beyond {bounds}")
        worst[name] = max(worst.get(name, 0.0), err)
        del leaves, refs, out, want, got, ref
    log(phase="kernel checks", kernel="gradients", seconds=time.perf_counter() - t0)
    return worst


TRAIN_STEPS = 3
TRAIN_BATCH = 2
# extra arguments of the train CLI's subprocess (a CPU rehearsal's)
TRAIN_CLI_ARGS = ()
TRAIN_SEED = 11
# learning rates: the train CLI's defaults (v1, v2 1e-5; task tokens 5e-4;
# LoRA and distillation 1e-4)
TRAIN_LR = {"v1": 1e-5, "task_tokens": 5e-4, "v2": 1e-5, "lora": 1e-4,
            "lcm_distill": 1e-4}


def train_launches(cfg, mode: str) -> dict:
    """Forward launches of one train step (the backward recomputes plain
    versions and launches no hand kernel): two VAE encodes (image and
    masked image), the text towers, and the UNet evaluations: v1, LoRA and
    task tokens one UNet and one CLIP; v2 the base UNet, the BrushNet
    branch and both towers; distillation four UNet evaluations (the
    teacher's two, the student's online and target) and CLIP twice."""
    text = {"layer_norm": 2 * cfg.text_encoder.num_hidden_layers + 1}
    enc = vae_launches(cfg.vae, False)
    unet = unet_launches(cfg.unet)
    if mode == "v2":
        return _total((1, unet), (1, unet_launches(cfg.brushnet.base,
                                                   with_out_norm=False)),
                      (2, text), (2, enc))
    if mode == "lcm_distill":
        return _total((4, unet), (2, text), (2, enc))
    return _total((1, unet), (1, text), (2, enc))


def _clone(flat: dict) -> dict:
    return {k: v.detach().clone() for k, v in flat.items()}


def run_train_path(device):
    """Phase 7i: training at full width on the card, bf16 compute with fp32
    masters, random weights from seeds, 512^2, synthetic data
    (``train.data``): each mode's steps with their loss, grad_norm,
    seconds, device ms and peak memory, exact forward launches per step,
    frozen tensors bitwise unchanged and trained ones moved; the v1
    weights written and served; task tokens resumed; a LoRA served; the
    train CLI in a subprocess."""
    import functools
    import os
    import shutil
    import subprocess as sp

    from powerpaint_tpu_torch.core.config import ppt_v1_config, ppt_v2_config
    from powerpaint_tpu_torch.io import checkpoint
    from powerpaint_tpu_torch.io.weights import build_models, init_state
    from powerpaint_tpu_torch.pipelines.inpaint import InpaintPipeline
    from powerpaint_tpu_torch.train import data, distill
    from powerpaint_tpu_torch.train import loss as L
    from powerpaint_tpu_torch.train.cli import channels_last
    from powerpaint_tpu_torch.train.lora import init_lora_tree, save_lora_npz
    from powerpaint_tpu_torch.train.step import (
        AdamW,
        flatten,
        init_train_state,
        make_train_step,
        trainable_mask,
    )
    from powerpaint_tpu_torch.train.trainer import (
        load_train_state,
        save_train_state,
    )

    out_dir = os.path.join("smoke_out", "train")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    bf = torch.bfloat16
    cfg1, cfg2 = ppt_v1_config(), ppt_v2_config()
    tok1 = _tokenizer(cfg1)

    def stream(version, tok, n):
        it = data.batches(data.SyntheticSource(hw=HW, seed=TRAIN_SEED), tok,
                          TRAIN_BATCH, version=version, seed=TRAIN_SEED)
        return [next(it) for _ in range(n)]

    batches1 = stream("ppt-v1", tok1, 4)
    totals = {k: 0 for k in KERNELS}

    def take() -> dict:
        """The launches since the last take, added to the path's total."""
        counts = read_counts()
        for k, n in counts.items():
            totals[k] += n
        reset_counts()
        return counts

    def masters(cfg, seed=0):
        t0 = time.perf_counter()
        params = channels_last(init_state(
            cfg, torch.Generator(device=device).manual_seed(seed),
            device=device))
        log(phase="setup", path="train", seconds=time.perf_counter() - t0,
            params=sum(t.numel() for sd in params.values() for t in sd.values()))
        return params

    def steps(label, cfg, mode, state, step, batches, n, frozen=(),
              moved_each=None):
        """``n`` steps, each with exact launches, then the checks."""
        want = train_launches(cfg, mode)
        flat = flatten(state.params)
        before = _clone({k: flat[k] for k in flat})
        frozen_before = {k: v for k, v in before.items() if k in frozen}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rows = []
        take()
        for i in range(n):
            prev = _clone(flatten(state.params)) if moved_each else None
            batch = batches[i % len(batches)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, metrics = step(state, batch, TRAIN_SEED)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = take()
            check(launches == want, f"train {label} step {i}: launches "
                                    f"{launches}, expected {want}")
            row = {k: float(v) for k, v in metrics.items()}
            check(all(np.isfinite(v) for v in row.values()),
                  f"train {label} step {i}: {row}")
            if moved_each:
                now = flatten(state.params)
                moved = any(not torch.equal(now[k], prev[k]) for k in now)
                check(moved == moved_each(i),
                      f"train {label} step {i}: params moved {moved}")
            rows.append(dict(step=state.step, seconds=secs, **row))
        peak = torch.cuda.max_memory_allocated()
        fams, top = {}, []
        batch = batches[n % len(batches)]
        ms = device_ms(lambda: step(state, batch, TRAIN_SEED), fams, top)
        take()
        now = flatten(state.params)
        for k in frozen_before:
            check(torch.equal(now[k], frozen_before[k]),
                  f"train {label}: frozen {k} changed")
        trained = [k for k in now if k not in frozen]
        unmoved = [k for k in trained if torch.equal(now[k], before[k])]
        check(not unmoved, f"train {label}: {len(unmoved)} trained tensors "
                           f"did not move, e.g. {unmoved[:3]}")
        log(train=label, mode=mode, batch=TRAIN_BATCH, card=CARD[0],
            steps=rows, seconds_per_step=[r["seconds"] for r in rows],
            device_ms_per_step=ms, device_ms_by_family=fams,
            top_kernels=top[:10], peak_memory_bytes=peak,
            forward_launches_per_step=want,
            trained_tensors=len(trained), frozen_tensors=len(frozen_before))
        return rows

    def v1_mode(mode, params, **kw):
        labels = trainable_mask(params, mode)
        tx = AdamW(TRAIN_LR[mode], labels=labels,
                   accumulate_steps=kw.get("accumulate", 1))
        state = init_train_state(params, tx, ema=kw.get("ema") is not None)
        step = make_train_step(L.make_v1_loss(cfg1, dtype=bf), tx,
                               ema_decay=kw.get("ema"),
                               draw=functools.partial(L.draw, cfg1))
        frozen = {k for k, t in labels.items() if not t}
        return state, step, frozen

    reset_counts()  # the path starts here

    # ---- v1: UNet + text encoder (task rows too); the VAE frozen
    params = masters(cfg1)
    state, step, frozen = v1_mode("v1", params)
    steps("v1", cfg1, "v1", state, step, batches1, TRAIN_STEPS, frozen)
    take()
    # the written weights served bitwise as the in-memory stack
    weights = os.path.join(out_dir, "weights")
    t0 = time.perf_counter()
    checkpoint.save_native(weights, cfg1, params)
    save_s = time.perf_counter() - t0
    image, mask = inputs(HW, 0)
    mem = InpaintPipeline(cfg1, params, tok1, dtype=bf, device=device)
    want_img = mem(image, mask, prompt="a red bench in a park", seed=1,
                   num_inference_steps=STEPS, guidance_scale=GUIDANCE)
    del mem
    t0 = time.perf_counter()
    served = checkpoint.load_ppt_v1(weights, config=cfg1, dtype=bf,
                                    device=device)
    load_s = time.perf_counter() - t0
    got_img = served(image, mask, prompt="a red bench in a park", seed=1,
                     num_inference_steps=STEPS, guidance_scale=GUIDANCE)
    nbytes = sum(os.path.getsize(os.path.join(r, f))
                 for r, _, fs in os.walk(weights) for f in fs)
    log(train="v1 weights served", bytes=nbytes, save_seconds=save_s,
        load_seconds=load_s, bitwise=bool(np.array_equal(got_img, want_img)))
    check(np.array_equal(got_img, want_img),
          "train v1: the written weights' image is not the in-memory stack's")
    del served, params, state, step
    shutil.rmtree(weights)
    torch.cuda.empty_cache()

    # ---- v1, accumulate 2 and EMA: params move on every second call
    params = masters(cfg1)
    state, step, frozen = v1_mode("v1", params, accumulate=2, ema=0.9)
    ema0 = _clone(state.ema)
    steps("v1 accumulate 2 + ema", cfg1, "v1", state, step, batches1, 4,
          frozen, moved_each=lambda i: i % 2 == 1)
    check(all(not torch.equal(state.ema[k], ema0[k]) for k in state.ema
              if k not in frozen), "train v1 ema: an EMA leaf did not move")
    take()
    del params, state, step, ema0
    torch.cuda.empty_cache()

    # ---- task tokens, then resumed: 2 steps, save, load, then the straight
    # run's third step and its profiled fourth
    params = masters(cfg1)
    state, step, frozen = v1_mode("task_tokens", params)
    steps("task_tokens", cfg1, "task_tokens", state, step, batches1,
          TRAIN_STEPS, frozen)
    take()
    straight = _clone({k: v for k, v in flatten(state.params).items()
                       if k not in frozen})
    del params, state, step
    torch.cuda.empty_cache()
    params = masters(cfg1)
    state, step, frozen = v1_mode("task_tokens", params)
    for i in range(2):
        step(state, batches1[i], TRAIN_SEED)
    path = os.path.join(out_dir, "state.npz")
    t0 = time.perf_counter()
    save_train_state(path, state)
    save_s = time.perf_counter() - t0
    del params, state
    torch.cuda.empty_cache()
    params = masters(cfg1)
    state, step, frozen = v1_mode("task_tokens", params)
    t0 = time.perf_counter()
    state = load_train_state(path, state)
    load_s = time.perf_counter() - t0
    # the straight run's third step and its profiled fourth
    for i in (2, 3):
        step(state, batches1[i], TRAIN_SEED)
    take()
    resumed = {k: v for k, v in flatten(state.params).items() if k not in frozen}
    diff = max(float((resumed[k] - straight[k]).abs().max()) for k in straight)
    bound = TRAIN_LR["task_tokens"] * (TRAIN_STEPS + 1)
    log(train="task_tokens resumed", state_bytes=os.path.getsize(path),
        save_seconds=save_s, load_seconds=load_s, max_abs_diff=diff,
        bound=bound, bitwise=all(torch.equal(resumed[k], straight[k])
                                 for k in straight))
    # the embedding backward sums rows with atomics: the runs may differ in
    # the last bits of a gradient, which Adam can turn into up to a step
    check(diff <= bound, f"train task_tokens: resumed run {diff} from the "
                         f"straight one, beyond lr x steps {bound}")
    os.remove(path)
    del params, state, step, straight, resumed
    torch.cuda.empty_cache()

    # ---- LoRA (rank 8) and LCM-LoRA distillation on the frozen teacher
    params = masters(cfg1)
    teacher = _clone(flatten(params))
    unet_meta = build_models(cfg1)["unet"]
    for mode in ("lora", "lcm_distill"):
        lora = init_lora_tree(unet_meta, 8, torch.Generator(device=device)
                              .manual_seed(1))
        tx = AdamW(TRAIN_LR[mode])
        state = init_train_state(lora, tx)
        if mode == "lora":
            loss_fn = L.make_lora_loss(L.make_v1_loss(cfg1, dtype=bf), params)
            draw = functools.partial(L.draw, cfg1)
        else:
            loss_fn = distill.make_lcm_distill_loss(cfg1, params, dtype=bf)
            draw = functools.partial(distill.draw, cfg1)
        step = make_train_step(loss_fn, tx, draw=draw)
        steps(mode, cfg1, mode, state, step, batches1, TRAIN_STEPS)
        take()
        flat = flatten(params)
        check(all(torch.equal(flat[k], teacher[k]) for k in teacher),
              f"train {mode}: the teacher changed")
        if mode == "lora":
            npz = os.path.join(out_dir, "lora.npz")
            save_lora_npz(npz, state.params)
            pipe = InpaintPipeline(cfg1, params, tok1, dtype=bf, device=device)
            base = pipe(image, mask, prompt="a red bench in a park", seed=1,
                        num_inference_steps=STEPS, guidance_scale=GUIDANCE)
            unmatched = pipe.load_lora_weights(npz)
            img = pipe(image, mask, prompt="a red bench in a park", seed=1,
                       num_inference_steps=STEPS, guidance_scale=GUIDANCE)
            d = np.abs(img.astype(np.int32) - base.astype(np.int32))
            log(train="lora served", sites=len(state.params), unmatched=unmatched,
                vs_base_max_uint8_diff=int(d.max()),
                vs_base_mean_uint8_diff=float(d.mean()))
            check(unmatched == [], f"train lora: unmatched {unmatched}")
            del pipe
        del state, step, loss_fn
        torch.cuda.empty_cache()
    del params, teacher
    torch.cuda.empty_cache()

    # ---- v2: the BrushNet branch and its task tower; the base frozen
    tok2 = _tokenizer(cfg2)
    batches2 = stream("ppt-v2", tok2, TRAIN_STEPS + 1)
    params = masters(cfg2)
    labels = trainable_mask(params, "v2")
    tx = AdamW(TRAIN_LR["v2"], labels=labels)
    state = init_train_state(params, tx)
    step = make_train_step(L.make_v2_loss(cfg2, dtype=bf), tx,
                           draw=functools.partial(L.draw, cfg2))
    steps("v2", cfg2, "v2", state, step, batches2, TRAIN_STEPS,
          {k for k, t in labels.items() if not t})
    take()
    del params, state, step
    torch.cuda.empty_cache()

    # ---- the train CLI in a subprocess, full width, then its LoRA served
    cli_out = os.path.join(out_dir, "cli")
    argv = [sys.executable, "-m", "powerpaint_tpu_torch.train.cli", "--mode",
            "lora", "--steps", "2", "--batch_size", "1", "--out", cli_out,
            "--log_every", "1", *TRAIN_CLI_ARGS]
    t0 = time.perf_counter()
    proc = sp.run(argv, capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    log(train="cli", argv=argv[1:], rc=proc.returncode, seconds=secs,
        stdout=proc.stdout.strip().splitlines()[-4:],
        stderr=proc.stderr.strip().splitlines()[-3:])
    check(proc.returncode == 0, f"train cli: exit code {proc.returncode}")
    state0 = init_state(cfg1, torch.Generator(device=device).manual_seed(0),
                        device=device, dtype=bf)
    pipe = InpaintPipeline(cfg1, state0, tok1, dtype=bf, device=device)
    unmatched = pipe.load_lora_weights(os.path.join(cli_out, "lora.npz"))
    img = pipe(image, mask, prompt="a red bench in a park", seed=1,
               num_inference_steps=STEPS, guidance_scale=GUIDANCE)
    take()
    check(unmatched == [], f"train cli lora: unmatched {unmatched}")
    check(img.shape == (1, HW, HW, 3), f"train cli lora: image {img.shape}")
    del pipe, state0
    shutil.rmtree(out_dir)
    torch.cuda.empty_cache()
    return totals


def tiny_train_reference(device) -> None:
    """Phase 8's training: three steps of ``v1``, ``v2`` and ``lora`` at the
    tiny configs in fp32 (TF32 off), 128^2, through the kernels on the
    card and through the plain versions on the CPU, from the same weights,
    batches and draws. Bounds: each step's loss within 1e-4 relative; the
    first step's gradients within 3e-4 of the largest (the kernels and the
    plain versions sum in other orders: 6e-5 of it seen; the CPU tests see
    1e-5 of it between the port and JAX); the parameters after three steps within lr
    per step of each other, at most 0.5% of them past 1e-2 of it (Adam's
    normalisation amplifies a gradient's last bits where a moment sits
    near 0)."""
    from powerpaint_tpu_torch.io.weights import build_models, init_state
    from powerpaint_tpu_torch.testing import tiny_v1_config, tiny_v2_config
    from powerpaint_tpu_torch.text.tokenizer import (
        HashTokenizer,
        TokenizerWrapper,
        add_task_tokens,
    )
    from powerpaint_tpu_torch.train import data
    from powerpaint_tpu_torch.train import loss as L
    from powerpaint_tpu_torch.train.lora import init_lora_tree
    from powerpaint_tpu_torch.train.step import (
        AdamW,
        flatten,
        init_train_state,
        make_train_step,
        trainable_mask,
        with_leaves,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tok = TokenizerWrapper(HashTokenizer(994))
    add_task_tokens(tok)
    lr = 1e-3
    for mode, cfg in (("v1", tiny_v1_config()), ("v2", tiny_v2_config()),
                      ("lora", tiny_v1_config())):
        version = "ppt-v2" if mode == "v2" else "ppt-v1"
        it = data.batches(data.SyntheticSource(hw=128, seed=5), tok, 2,
                          version=version, seed=5)
        batches = [next(it) for _ in range(TRAIN_STEPS)]
        draws = [L.draw(cfg, b, torch.Generator().manual_seed(i))
                 for i, b in enumerate(batches)]
        base = init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
        make = L.make_v2_loss if mode == "v2" else L.make_v1_loss
        runs = {}
        for dev in ("cpu", device):
            # copies: a step updates its parameters in place
            params = {f: {k: v.clone().to(dev) for k, v in sd.items()}
                      for f, sd in base.items()}
            if mode == "lora":
                lora = init_lora_tree(build_models(cfg)["unet"], 4,
                                      torch.Generator().manual_seed(1),
                                      device="cpu")
                tree = {m: {k: t.clone().to(dev) for k, t in f.items()}
                        for m, f in lora.items()}
                loss_fn = L.make_lora_loss(make(cfg), params)
                tx = AdamW(lr)
            else:
                tree = params
                loss_fn = make(cfg)
                tx = AdamW(lr, labels=trainable_mask(params, mode))
            state = init_train_state(tree, tx)
            step = make_train_step(loss_fn, tx)
            dev_draws = [{k: v.to(dev) for k, v in d.items()} for d in draws]
            # the first step's gradients
            families = loss_fn.families
            leaves = {k: v.detach().clone().requires_grad_(True)
                      for k, v in flatten(tree if families is None else
                                          {f: tree[f] for f in families}).items()}
            loss, _ = loss_fn(with_leaves(tree, leaves), batches[0],
                              dev_draws[0])
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            losses = []
            for b, d in zip(batches, dev_draws):
                _, m = step(state, b, d)
                losses.append(float(m["loss"]))
            runs[str(dev)] = dict(losses=losses,
                                  grads={k: v.cpu() for k, v in grads.items()},
                                  params={k: v.cpu() for k, v in
                                          flatten(state.params).items()})
        cpu, card = runs["cpu"], runs[str(device)]
        loss_err = max(abs(a - b) / abs(a) for a, b in zip(cpu["losses"],
                                                           card["losses"]))
        gmax = max(float(g.abs().max()) for g in cpu["grads"].values())
        grad_err = max(float((cpu["grads"][k] - card["grads"][k]).abs().max())
                       for k in cpu["grads"])
        far = total = 0
        p_err = 0.0
        for k, p in cpu["params"].items():
            d = (p - card["params"][k]).abs()
            p_err = max(p_err, float(d.max()))
            far += int((d > 1e-2 * lr * TRAIN_STEPS).sum())
            total += d.numel()
        log(tiny_reference=f"train {mode}", losses_cpu=cpu["losses"],
            losses_card=card["losses"], loss_max_rel_err=loss_err,
            grad_max_abs_err=grad_err, grad_bound=3e-4 * gmax,
            param_max_abs_err=p_err, param_bound=lr * TRAIN_STEPS,
            params_past_hundredth_lr_steps=far, params=total)
        check(loss_err <= 1e-4, f"tiny train {mode}: loss {loss_err}")
        check(grad_err <= 3e-4 * gmax, f"tiny train {mode}: gradient {grad_err}")
        check(p_err <= lr * TRAIN_STEPS and far <= 0.005 * total,
              f"tiny train {mode}: params {p_err}, {far} of {total} far")
    torch.backends.cudnn.allow_tf32 = True


# ---------------------------------------------------------------------------
# phase 7j: the mesh
# ---------------------------------------------------------------------------

MESH_STEPS = 4
MESH_SEEDS = (1, 2)
MESH_TRAIN_HW = 512
MESH_KERNELS = ("flash_attention", "conv3x3_gn_silu", "conv3x3", "group_norm",
                "group_norm_stats", "layer_norm")  # B1-B5 (B5: conv3x3)
MESH_LAUNCHES = {}  # kernel -> {"tp" | "dp" | "sp": [per rank]}
MESH_U8 = (18, 2.0)  # max, mean: the batch-variance bound of phases 3-7
MESH_LOSS_RTOL = 1e-3
MESH_LR = 1e-3
MESH_FULL = True  # the published widths (a CPU rehearsal sets False)
# part (e): one canvas's rows over the two ranks (sequence parallelism)
SP_HW = 1024
SP_KERNELS = ("flash_attention_lse", "group_norm_moments", "conv3x3_gn_silu",
              "conv3x3")  # B1's ring hops, B3's moments, B2, B5


def run_mesh_path(device):
    """Phase 7j: ppt-v1 at full width over a mesh of processes on this one
    card (``parallel.dryrun``'s rank functions). Two ranks share the card
    over gloo (NCCL refuses two ranks on one device): (a) data 1 x model 2,
    a one-image call within ``MESH_U8`` of the one-process call; (b) data
    2 x model 1, a call of one image per seed, each image bitwise the
    one-process call of its seed; the B1-B5 launches of each rank, and the
    heads the flash kernel ran at; (c) a ZeRO-3 v1 train step at data 2
    (global batch 2, bf16 compute over fp32 masters) against the
    one-process step: the loss to ``MESH_LOSS_RTOL``, the task-token rows to
    the JAX bound, the large leaves' bytes at rest about half. Then (d) one
    rank over NCCL: the data-parallel and the ZeRO-3 step bitwise the
    plain step. (e) Sequence parallelism at data 2 on one ``SP_HW``^2
    canvas (``dryrun.sp_card_check``): the image within ``MESH_U8`` of the
    one-process call, each rank's launches of the ring's flash mode, the
    moments mode, B2 and B5, its seconds and peak bytes against the one
    process's, the copies it staged through pinned memory; the ring alone
    against one flash launch over the whole K/V. Every rank on the card;
    the parent launches nothing, so the path's launches are the ranks'
    in (a), (b) and (e), summed (per rank and part in ``MESH_LAUNCHES``)."""
    from powerpaint_tpu_torch.parallel import dryrun
    from powerpaint_tpu_torch.parallel.launch import spawn

    cuda = device.type == "cuda"
    dev = f"cuda:{device.index or 0}" if cuda else "cpu"
    devices = [dev, dev]
    t0 = time.perf_counter()
    ranks = spawn(dryrun.card_rank, devices,
                  (devices, MESH_STEPS, HW, MESH_SEEDS, MESH_TRAIN_HW, MESH_FULL,
                   SP_HW),
                  backend="gloo", timeout=900)
    log(phase="mesh", part="(a)-(c), (e) two gloo ranks on one card",
        seconds=time.perf_counter() - t0, card=CARD[0])
    for r, out in enumerate(ranks):
        check(out["device"] == dev and out.get("current_device") ==
              (device.index or 0 if cuda else None),
              f"mesh rank {r} ran on {out['device']}")
        for part in ("tp", "dp"):
            got = out[part]
            log(path="mesh", rank=r, part=part, max_uint8_diff=got["max"],
                mean_uint8_diff=got["mean"], equal_images=got["equal_images"],
                seconds=got["seconds"], launches=got["launches"],
                attention_heads_dims=got["attention_shapes"])
            for k in MESH_KERNELS:
                check(got["launches"][k] > 0,
                      f"mesh rank {r} ({part}): {k} was not launched")
            for k in KERNELS:
                MESH_LAUNCHES.setdefault(k, {}).setdefault(part, []).append(
                    got["launches"][k])
        tp, dp = out["tp"], out["dp"]
        log(path="mesh", rank=r, part="one process, batched against alone",
            max_uint8_diff=out["batch_vs_alone"]["max"],
            mean_uint8_diff=out["batch_vs_alone"]["mean"])
        check(tp["max"] <= MESH_U8[0] and tp["mean"] <= MESH_U8[1],
              f"mesh rank {r} (a): data 1 x model 2 against one process: "
              f"max {tp['max']}, mean {tp['mean']}")
        check({(4, 40), (4, 80)} <= set(map(tuple, tp["attention_shapes"])),
              f"mesh rank {r} (a): attention at {tp['attention_shapes']}, "
              "not 4 of 8 heads")
        check(all(dp["equal_images"]),
              f"mesh rank {r} (b): the data-parallel images are not bitwise "
              f"the one-process calls of their seeds: {dp['equal_images']}")
        z = out["zero3"]
        share = z["bytes_at_rest"] / z["whole_bytes"]
        log(path="mesh", rank=r, part="zero3", loss=z["loss"],
            one_process_loss=z["ref_loss"], grad_norm=z["grad_norm"],
            one_process_grad_norm=z["ref_grad_norm"], update=z["update"],
            bytes_at_rest=z["bytes_at_rest"], whole_bytes=z["whole_bytes"],
            share_at_rest=share, peak_bytes=z["peak_bytes"],
            one_process_peak_bytes=out.get("ref_peak_bytes"),
            seconds=z["seconds"], card=CARD[0])
        check(abs(z["loss"] - z["ref_loss"]) <= MESH_LOSS_RTOL * abs(z["ref_loss"]),
              f"mesh rank {r} (c): ZeRO-3 loss {z['loss']} against "
              f"{z['ref_loss']}")
        check(z["update"]["max"] <= 2.1 * MESH_LR
              and z["update"]["tight"] >= 0.99,
              f"mesh rank {r} (c): task-token rows {z['update']}")
        check(0.45 <= share <= 0.55 and z["layout_kept"]
              and z["big_share"] == 0.5,
              f"mesh rank {r} (c): {share} of the large leaves at rest, "
              f"layout kept {z['layout_kept']}")
    check(np.array_equal(ranks[0]["zero3"]["rows"], ranks[1]["zero3"]["rows"]),
          "mesh (c): the ranks' replicated task-token rows differ")
    one = ranks[0]["sp"]
    for r, out in enumerate(ranks):
        sp = out["sp"]
        log(path="mesh", rank=r, part="(e) sequence parallel", hw=SP_HW,
            steps=MESH_STEPS, max_uint8_diff=sp["max"],
            mean_uint8_diff=sp["mean"], shape=sp["shape"],
            seconds=sp["seconds"], one_process_seconds=one["one_process_seconds"],
            peak_bytes=sp["peak_bytes"],
            one_process_peak_bytes=one["one_process_peak_bytes"],
            launches=sp["launches"], staged=sp["staged"], ring=sp["ring"],
            card=CARD[0])
        check(sp["shape"] == [1, SP_HW, SP_HW, 3],
              f"mesh rank {r} (e): an image of {sp['shape']}")
        check(sp["max"] <= MESH_U8[0] and sp["mean"] <= MESH_U8[1],
              f"mesh rank {r} (e): sequence parallel against one process: "
              f"max {sp['max']}, mean {sp['mean']}")
        for k in SP_KERNELS:
            check(sp["launches"][k] > 0,
                  f"mesh rank {r} (e): {k} was not launched")
        for k in KERNELS:
            MESH_LAUNCHES.setdefault(k, {}).setdefault("sp", []).append(
                sp["launches"][k])
        for ring in sp["ring"]:
            check(ring["ok"], f"mesh rank {r} (e): the ring at {ring['shape']}: "
                  f"{ring['max_rel_err']} of the largest output, "
                  f"{ring['norm_rel_err']} of the 2-norm, beyond {ring['rtol']}")

    t1 = time.perf_counter()
    backend = "nccl" if cuda else "gloo"
    one = spawn(dryrun.nccl_rank, [dev], ([dev], MESH_TRAIN_HW, 2, MESH_FULL,
                                          backend),
                backend=backend, timeout=600)[0]
    log(phase="mesh", part="(d) one NCCL rank", seconds=time.perf_counter() - t1,
        results={k: one[k] for k in ("dp", "zero3", "backend")})
    for part in ("dp", "zero3"):
        got = one[part]
        check(one["backend"] == backend and got["loss_equal"]
              and got["grad_norm_equal"] and got["params_equal"] == got["params"],
              f"mesh (d): the {part} step over NCCL is not bitwise the plain "
              f"step: {got}")
    log(phase="mesh", seconds=time.perf_counter() - t0)
    return {k: sum(sum(ns) for ns in MESH_LAUNCHES.get(k, {}).values())
            for k in KERNELS}


def run_attn_bf16_path(device):
    """Phase 7k: ``scripts/torch_perf_attn_bf16.py`` through its
    ``main()``, the entry point of the bf16-softmax experiment (the script
    exits when the mode misses its plain version's bound or B1 meets it).
    It launches B1 and the mode, and no other kernel. Returns the launches
    and the script's rows, which time the mode for the kernels line."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent / "scripts" / "torch_perf_attn_bf16.py"
    spec = importlib.util.spec_from_file_location("torch_perf_attn_bf16", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    reset_counts()
    rows = script.main()
    check([r["shape"] for r in rows] == [list(x) for x in script.SHAPES]
          and all(r["ok"] for r in rows), f"attn bf16 script: rows {rows}")
    return _path_counts("attn bf16 script", {
        k: int(k in ("flash_attention", "flash_attention_bf16_softmax"))
        for k in KERNELS}), rows


def script_timing(row: dict) -> dict:
    """A row of ``scripts/torch_perf_attn_bf16.py`` as a timing row of the
    mode, shape (B, Sq, Skv, N, D)."""
    b, s, n, d = row["shape"]
    return dict(shape=[b, s, s, n, d], ms=row["bf16_softmax_ms"],
                stream_ms=row["bf16_softmax_stream_ms"],
                host_ms=row["bf16_softmax_host_ms"], plain_ms=row["plain_ms"],
                bound_ms=row["tensor_core_bound_ms"], bound_by=row["bound_by"],
                library_ms=None, **{k: row[k] for k in (
                    "flash_attention_ms", "sdpa_ms", "exp2_floor_ms",
                    "exp2_floor_packed_ms")})


META = {
    "flash_attention": dict(
        route="cuda", source="powerpaint_tpu_torch/csrc/flash_attention.cu",
        replaces="powerpaint_tpu/ops/flash_attention.py:28"),
    "flash_attention_lse": dict(
        route="cuda", source="powerpaint_tpu_torch/csrc/flash_attention.cu",
        replaces="powerpaint_tpu/ops/flash_attention.py:28"),
    "flash_attention_bf16_softmax": dict(
        route="cuda", source="powerpaint_tpu_torch/csrc/flash_attention.cu",
        replaces="scripts/perf_attn_bf16.py:43"),
    "group_norm_moments": dict(
        route="cuda", source="powerpaint_tpu_torch/csrc/group_norm.cu",
        replaces="powerpaint_tpu/ops/norms_pallas.py:78"),
    "group_norm": dict(
        route="cuda", source="powerpaint_tpu_torch/csrc/group_norm.cu",
        replaces="powerpaint_tpu/ops/norms_pallas.py:78"),
    "group_norm_stats": dict(
        route="cuda", source="powerpaint_tpu_torch/csrc/group_norm.cu",
        replaces="powerpaint_tpu/ops/norms_pallas.py:78"),
    "gn_silu_quantize_int8": dict(
        route="cuda", source="powerpaint_tpu_torch/csrc/group_norm.cu",
        replaces="powerpaint_tpu/ops/conv_pallas.py:295"),
    "quantize_int8": dict(
        route="cuda", source="powerpaint_tpu_torch/csrc/group_norm.cu",
        replaces="powerpaint_tpu/ops/conv_pallas.py:272"),
    "layer_norm": dict(
        route="cuda", source="powerpaint_tpu_torch/csrc/layer_norm.cu",
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
    print(read_card(), flush=True)
    log(sms=SM_COUNT[0], max_sm_clock_hz=SM_CLOCK_HZ[0])
    log(torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0),
        capability=list(torch.cuda.get_device_capability(0)))
    t0 = time.perf_counter()
    nvcc_logs = _build.build(_build.SOURCES)
    log(phase="build", sources=list(_build.SOURCES),
        seconds=time.perf_counter() - t0)
    kernel_resources(nvcc_logs)

    # phase 2: kernels against their plain versions, and their times
    t0 = time.perf_counter()
    summary, timings = check_kernels(device)
    grad_errs = grad_checks(device)
    log(phase="kernel checks", seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    batch_invariance(device)
    log(phase="batch invariance", seconds=time.perf_counter() - t0)

    # phases 3 to 7: the main paths, then the small references
    launches = {k: 0 for k in KERNELS}
    refs = {}
    paths = (("ppt-v1", run_v1_path), ("ppt-v2", run_v2_path),
             ("ppt-v1 int8", lambda d: run_int8_path(d, "ppt-v1", refs["ppt-v1"])),
             ("ppt-v2 int8", lambda d: run_int8_path(d, "ppt-v2", refs["ppt-v2"])),
             ("cli", run_cli),
             ("ppt-v1 + controlnet", lambda d: run_cn_path(d, refs["ppt-v1"])),
             ("annotators + safety", run_annotator_path),
             ("samplers", run_sampler_path),
             ("checkpoints + lora", run_checkpoint_path),
             ("call surface", run_call_surface_path),
             ("vae extras", run_vae_extras_path),
             ("adapters", run_adapter_path),
             ("serving", lambda d: run_serving_path(d, refs["ppt-v1"])),
             ("training", run_train_path),
             ("mesh", run_mesh_path),
             ("attn bf16 script", run_attn_bf16_path))
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
    tiny_train_reference(device)
    log(phase="tiny reference", seconds=time.perf_counter() - t0)

    kernels = []
    script_rows = refs["attn bf16 script"]
    timings["flash_attention_bf16_softmax"] = [script_timing(r) for r in script_rows]
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
            **{k: head[k] for k in ("library_scope", "bf16_kernel_ms",
                                    "quantize_ms", "product_ms", "unfused_ms")
               if k in head}))
        if name in grad_errs:  # its gradient's check (phase 2)
            kernels[-1]["grad_max_abs_err"] = grad_errs[name]
        if name in MESH_LAUNCHES:  # phase 7j's ranks, per part and rank
            kernels[-1]["mesh_launches"] = MESH_LAUNCHES[name]
        for r in timings.get(name + " (given statistics)", []):
            kernels[-1].setdefault("given_statistics", []).append(
                {k: r[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                   "bound_by")})
        keys = ("shape", "ms", "bound_ms", "bound_by", "plain_ms", "library_ms")
        if name == "flash_attention":  # the head dims past the UNet's
            kernels[-1]["head_dims"] = [
                {k: r[k] for k in keys + ("library_backend",)}
                for r in timings[name] if r["shape"][-1] >= 512]
            kernels[-1]["image_tokens"] = [  # the IP-Adapter's S_kv = 4
                {k: r[k] for k in keys + ("library_backend",)}
                for r in timings[name] if r["shape"][2] == 4]
        if name == "flash_attention_bf16_softmax":  # the script's shapes
            kernels[-1]["script_shapes"] = timings[name]
            kernels[-1]["sdpa_scope"] = script_rows[0]["sdpa_scope"]
        if name == "layer_norm":  # the ViT-H tower's and the projection's
            ip_rows = [list(shape) for shape, _ in IP_LN_SHAPES]
            kernels[-1]["ip_rows"] = [{k: r[k] for k in keys}
                                      for r in timings[name]
                                      if r["shape"] in ip_rows]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
