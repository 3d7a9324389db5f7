"""Command line (the port of ``powerpaint_tpu/serve/cli.py``; reference
app.py:546-556 flags). Two modes:

- one-shot: ``python -m powerpaint_tpu_torch.serve.cli --image in.png
  --mask m.png --task text-guided --prompt "a dog" --output out.png``
- serve: ``--serve`` launches the web UI (``serve.app.launch``: gradio
  when installed, else the HTTP server, ``POST /inpaint``), with
  ``--micro-batch N`` (default 4) coalescing concurrent requests and
  ``--share`` going to gradio.

``--aot-cache FILE`` is the cold-start cache of the built kernels
(``io.aot``): loaded if the file exists, else dumped there after the
one-shot call (in serve mode, after the first request, without
micro-batching).

The options, their choices and defaults are the JAX package's, plus
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch versions of
the kernels) and ``--controlnet_dir``. ``--checkpoint_dir`` loads a
reference-layout checkpoint (``io.checkpoint``), and ``--lora`` /
``--textual_inversion`` apply to it; without one a random-weight stack
runs: the full path executes, the image is noise. ``--control_type`` runs
ppt-v1 + ControlNet (``pipelines.controlnet``) on the map
``tasks.control.get_control_image`` makes of the processed image: the
branch is ``--controlnet_dir``'s (a diffusers ControlNet directory,
``io.checkpoint.load_controlnet``), or without a checkpoint the demo
stack's random branch from seed 0; depth, hed and pose run their annotator
with random weights from seed 0 unless one is registered, and canny's map
is made on the host (no map needs OpenCV). ``POWERPAINT_INT8=1`` in the
environment runs the int8 W8A8 ResNet units, as in the JAX package.
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("powerpaint_tpu_torch")
    p.add_argument("--version", choices=["ppt-v1", "ppt-v2"],
                   default="ppt-v1")
    p.add_argument("--checkpoint_dir", default=None,
                   help="reference-layout checkpoint root (or, for ppt-v1, "
                        "an original-SD single file)")
    p.add_argument("--weight_dtype", choices=["bfloat16", "float32"],
                   default="bfloat16")
    p.add_argument("--lora", action="append", default=[], metavar="PATH[:SCALE]",
                   help="merge a LoRA checkpoint (diffusers/kohya format) "
                        "into the loaded weights; repeatable")
    p.add_argument("--textual_inversion", action="append", default=[],
                   metavar="PATH[:TOKEN]",
                   help="register a user textual-inversion embedding; "
                        "repeatable")
    p.add_argument("--clip_skip", type=int, default=0,
                   help="skip the last N CLIP layers when encoding")
    p.add_argument("--serve", action="store_true",
                   help="launch the web UI (gradio, else the HTTP server)")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--share", action="store_true")
    p.add_argument("--micro-batch", dest="micro_batch", type=int, default=4,
                   help="coalesce up to N concurrent HTTP requests into one "
                        "batched generate (0/1 disables)")
    # one-shot args (reference Gradio widget parameters, app.py:664-690)
    p.add_argument("--image", help="input image path")
    p.add_argument("--mask", help="mask image path (white = repaint)")
    p.add_argument("--output", default="output.png")
    p.add_argument("--task", default="text-guided",
                   choices=["text-guided", "shape-guided", "object-removal",
                            "image-outpainting"])
    p.add_argument("--prompt", default="")
    p.add_argument("--negative_prompt", default="")
    p.add_argument("--fitting_degree", type=float, default=1.0)
    p.add_argument("--steps", type=int, default=45)
    p.add_argument("--guidance_scale", type=float, default=7.5)
    p.add_argument("--seed", type=int, default=0)
    # a literal copy of powerpaint_tpu_torch.schedulers.SCHEDULERS, so
    # --help imports no torch; tests/test_torch_cli.py holds the two equal
    p.add_argument("--scheduler", default=None,
                   choices=["ddim", "pndm", "unipc", "dpm", "euler",
                            "euler_a", "heun", "lms", "deis", "dpm_sde",
                            "lcm"],
                   help="sampler (default: ddim for v1, unipc for v2, the "
                        "reference defaults)")
    p.add_argument("--control_type", default=None,
                   choices=[None, "canny", "depth", "hed", "pose"],
                   help="ControlNet conditioning (ppt-v1 only): the map "
                        "of the processed image; depth, hed and pose run "
                        "their annotator (random weights unless one is "
                        "registered)")
    p.add_argument("--controlnet_dir", default=None, metavar="DIR",
                   help="diffusers ControlNet directory (config.json and "
                        "diffusion_pytorch_model.safetensors) for "
                        "--control_type")
    p.add_argument("--horizontal_expansion", type=float, default=1.0)
    p.add_argument("--vertical_expansion", type=float, default=1.0)
    p.add_argument("--short_side", type=int, default=640,
                   help="resize short side before inference (640 tasks / "
                        "512 outpaint in the reference)")
    p.add_argument("--tiny", action="store_true",
                   help="use the tiny test config (fast smoke runs; with "
                        "--checkpoint_dir, the checkpoint's)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the call to DIR")
    p.add_argument("--aot-cache", dest="aot_cache", default=None,
                   metavar="FILE",
                   help="cold-start cache of the built kernels: load FILE "
                        "if it exists, else dump it there after the call")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cpu runs the kernels' "
                        "plain PyTorch versions)")
    return p


def control_problems(args) -> list:
    """What stops ``--control_type`` / ``--controlnet_dir`` as given."""
    out = []
    if args.controlnet_dir and not args.control_type:
        out.append("--controlnet_dir needs --control_type")
    if args.control_type and args.version != "ppt-v1":
        out.append("--control_type needs --version ppt-v1 (the reference "
                   "offers ControlNet on ppt-v1 only)")
    if args.control_type and args.checkpoint_dir and not args.controlnet_dir:
        out.append("--control_type with --checkpoint_dir needs "
                   "--controlnet_dir")
    return out


def build_pipeline(args):
    """The pipeline of ``--checkpoint_dir``, or the random-weight demo stack
    of ``args.version`` (full width or ``--tiny``, from seed 0), on
    ``args.device``, with ``--lora`` and ``--textual_inversion`` applied;
    with ``--control_type``, the ppt-v1 + ControlNet pipeline over it
    (``--controlnet_dir``'s branch, or the demo stack's)."""
    import torch

    from powerpaint_tpu_torch.testing import tiny_v1_config, tiny_v2_config

    dtype = torch.bfloat16 if args.weight_dtype == "bfloat16" else torch.float32
    v1 = args.version == "ppt-v1"
    if args.checkpoint_dir:
        from powerpaint_tpu_torch.io.checkpoint import load_ppt_v1, load_ppt_v2

        config = None
        if args.tiny:
            config = tiny_v1_config() if v1 else tiny_v2_config()
        load = load_ppt_v1 if v1 else load_ppt_v2
        pipe = load(args.checkpoint_dir, config=config, dtype=dtype,
                    device=args.device)
    else:
        pipe = random_pipeline(args, dtype)
    pipe = apply_adapters(pipe, args)
    if args.controlnet_dir:
        from powerpaint_tpu_torch.io.checkpoint import load_controlnet
        from powerpaint_tpu_torch.pipelines.controlnet import ControlNetPipeline

        pipe = ControlNetPipeline.from_pipeline(pipe, load_controlnet(
            args.controlnet_dir, dtype=dtype, device=args.device))
    return pipe


def random_pipeline(args, dtype):
    """The random-weight demo stack of ``args.version``, full width or
    ``--tiny``, from seed 0, on ``args.device``."""
    import torch

    from powerpaint_tpu_torch.core.config import (
        ppt_v1_config,
        ppt_v1_controlnet_config,
        ppt_v2_config,
    )
    from powerpaint_tpu_torch.io.weights import init_state
    from powerpaint_tpu_torch.testing import (
        tiny_v1_config,
        tiny_v1_controlnet_config,
        tiny_v2_config,
    )
    from powerpaint_tpu_torch.text.tokenizer import (
        HashTokenizer,
        TokenizerWrapper,
        add_task_tokens,
    )

    v1 = args.version == "ppt-v1"
    # the demo branch only where no ControlNet directory brings one
    control = bool(args.control_type) and not args.controlnet_dir
    if args.tiny:
        cfg = tiny_v1_config() if v1 else tiny_v2_config()
        if control:
            cfg = tiny_v1_controlnet_config()
        vocab = 1024
    else:
        cfg = ppt_v1_config() if v1 else ppt_v2_config()
        if control:
            cfg = ppt_v1_controlnet_config()
        vocab = 49408
    device = torch.device(args.device)
    state = init_state(cfg, torch.Generator(device=device).manual_seed(0),
                       device=device, dtype=dtype)
    tok = TokenizerWrapper(HashTokenizer(vocab_size=vocab))
    add_task_tokens(tok)
    if control:
        from powerpaint_tpu_torch.pipelines.controlnet import ControlNetPipeline

        return ControlNetPipeline(cfg, state, tok, dtype=dtype, device=device)
    if v1:
        from powerpaint_tpu_torch.pipelines.inpaint import InpaintPipeline

        return InpaintPipeline(cfg, state, tok, dtype=dtype, device=device)
    from powerpaint_tpu_torch.pipelines.brushnet import BrushNetPipeline

    return BrushNetPipeline(cfg, state, tok, dtype=dtype, device=device)


def apply_adapters(pipe, args):
    """``--lora PATH[:SCALE]`` (scale 1 by default) and
    ``--textual_inversion PATH[:TOKEN]`` (the file's own token name by
    default), in the order given."""
    for spec in args.lora:
        path, _, scale = spec.rpartition(":")
        if not path or not _is_float(scale):
            path, scale = spec, "1.0"
        unmatched = pipe.load_lora_weights(path, scale=float(scale))
        msg = f"lora: merged {path} (scale {scale})"
        if unmatched:
            msg += f"; {len(unmatched)} unmatched modules"
        print(msg)
    for spec in args.textual_inversion:
        path, _, token = spec.rpartition(":")
        if not path:
            path, token = spec, None
        pipe.add_textual_inversion(path, token=token or None)
        print(f"textual inversion: registered {spec}")
    return pipe


def _is_float(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def run_one_shot(args) -> int:
    import numpy as np
    from PIL import Image

    from powerpaint_tpu_torch.core.metrics import torch_profile_trace
    from powerpaint_tpu_torch.tasks.postprocess import blend_result
    from powerpaint_tpu_torch.tasks.preprocess import (
        crop_to_multiple_of_8,
        outpaint_canvas,
        resize_short_side,
        to_numpy_image,
        to_numpy_mask,
    )

    if not args.image:
        print("error: --image is required", file=sys.stderr)
        return 2

    image = to_numpy_image(Image.open(args.image))
    short = 512 if args.task == "image-outpainting" else args.short_side
    image = resize_short_side(image, short)

    if args.task == "image-outpainting":
        image, mask = outpaint_canvas(
            image, args.horizontal_expansion, args.vertical_expansion)
    else:
        if not args.mask:
            print("error: --mask is required for this task", file=sys.stderr)
            return 2
        mask = to_numpy_mask(Image.open(args.mask))
        if mask.shape[:2] != image.shape[:2]:
            mask = resize_short_side(mask, short)
    image = crop_to_multiple_of_8(image)
    mask = mask[: image.shape[0], : image.shape[1]]

    pipe = build_pipeline(args)
    aot_loaded = load_aot(pipe, args.aot_cache)
    kwargs = {}
    if args.scheduler is not None:
        kwargs["scheduler"] = args.scheduler
    note = ""
    if args.control_type:
        t0 = time.time()
        kwargs["control_image"] = control_map(args, image)
        note = f", control {args.control_type}"
        print(f"control: {args.control_type} map ({image.shape[1]}x"
              f"{image.shape[0]}) in {time.time() - t0:.1f}s")

    t0 = time.time()
    with torch_profile_trace(args.profile):
        out = pipe(
            image, mask,
            prompt=args.prompt,
            negative_prompt=args.negative_prompt,
            task=args.task,
            fitting_degree=args.fitting_degree,
            num_inference_steps=args.steps,
            guidance_scale=args.guidance_scale,
            seed=args.seed,
            clip_skip=args.clip_skip,
            **kwargs,
        )
    dt = time.time() - t0
    final = blend_result(out[0], image, mask)
    Image.fromarray(np.asarray(final)).save(args.output)
    if args.aot_cache and not aot_loaded:
        # after the blend, so the cache holds the host natives it built too
        try:
            pipe.aot_dump(args.aot_cache)
            print(f"aot: dumped {args.aot_cache}")
        except Exception as e:
            print(f"aot: dump failed: {e}", file=sys.stderr)
    print(f"wrote {args.output} ({final.shape[1]}x{final.shape[0]}) "
          f"in {dt:.1f}s ({args.steps} steps{note})")
    return 0


def load_aot(pipe, path) -> bool:
    """``--aot-cache``: install the file's kernels when it exists (True);
    a file that is refused is reported and the kernels build from the
    sources as usual."""
    import os

    if not path or not os.path.exists(path):
        return False
    try:
        pipe.aot_load(path)
    except Exception as e:
        print(f"aot: ignoring {path}: {e}", file=sys.stderr)
        return False
    print(f"aot: loaded {path}", flush=True)
    return True


def control_map(args, image):
    """``get_control_image`` of the processed image, at its size. depth,
    hed and pose run their annotator network, with random weights from
    seed 0 (the tiny DPT with ``--tiny``) where none is registered."""
    import torch

    from powerpaint_tpu_torch.tasks import control
    from powerpaint_tpu_torch.tasks.preprocess import resize_to

    kind = args.control_type
    if kind in control._ANNOTATORS and kind not in control._REGISTRY:
        from powerpaint_tpu_torch.io.weights import random_annotator_state
        from powerpaint_tpu_torch.tasks.pose import OpenposeBodyPreprocessor

        family, cls = {"depth": ("dpt", control.DPTDepthPreprocessor),
                       "hed": ("hed", control.HEDPreprocessor),
                       "pose": ("bodypose", OpenposeBodyPreprocessor)}[kind]
        extra = {}
        if family == "dpt":
            from powerpaint_tpu_torch.core.config import dpt_hybrid_midas_config
            from powerpaint_tpu_torch.testing import tiny_dpt_config

            extra["config"] = (tiny_dpt_config() if args.tiny
                               else dpt_hybrid_midas_config())
        state = random_annotator_state(
            family, torch.Generator(device=args.device).manual_seed(0),
            device=args.device, **extra)
        out = cls(state=state, device=args.device, **extra)(image)
    else:
        out = control.get_control_image(kind, image)
    if out.shape[:2] != image.shape[:2]:  # depth's own 1024^2
        out = resize_to(out, None, *image.shape[:2])[0]
    return out


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    problems = control_problems(args)
    if problems:
        parser.error("; ".join(problems))
    if args.scheduler is not None:
        # LCM's step bound and the step range, before the stack is built
        from powerpaint_tpu_torch.core.config import SchedulerConfig
        from powerpaint_tpu_torch.core.validation import check_scheduler

        check_scheduler(args.scheduler, SchedulerConfig(), args.steps)
    if args.serve:
        from powerpaint_tpu_torch.serve.app import launch

        return launch(args)
    return run_one_shot(args)


if __name__ == "__main__":
    sys.exit(main())
