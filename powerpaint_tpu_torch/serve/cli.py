"""Command line, one-shot mode (the port of ``powerpaint_tpu/serve/cli.py``;
reference app.py:546-556 flags).

    python -m powerpaint_tpu_torch.serve.cli --image in.png --mask m.png \
        --task text-guided --prompt "a dog" --output out.png

The options, their choices and defaults are the JAX package's, plus
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch versions of
the kernels). Without a checkpoint a random-weight stack runs: the full
path executes, the image is noise. ``POWERPAINT_INT8=1`` in the environment
runs the int8 W8A8 ResNet units, as in the JAX package. Options whose
modules are not ported yet stop the command with the ROADMAP item that
brings them; none is ignored.
"""

from __future__ import annotations

import argparse
import sys
import time

# the sampler each path has in the port (ROADMAP A13 brings the others)
PORTED_SCHEDULER = {"ppt-v1": "ddim", "ppt-v2": "unipc"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("powerpaint_tpu_torch")
    p.add_argument("--version", choices=["ppt-v1", "ppt-v2"],
                   default="ppt-v1")
    p.add_argument("--checkpoint_dir", default=None,
                   help="reference-layout checkpoint root (not ported yet: "
                        "ROADMAP A14)")
    p.add_argument("--weight_dtype", choices=["bfloat16", "float32"],
                   default="bfloat16")
    p.add_argument("--lora", action="append", default=[], metavar="PATH[:SCALE]",
                   help="merge a LoRA checkpoint (not ported yet: ROADMAP A14)")
    p.add_argument("--textual_inversion", action="append", default=[],
                   metavar="PATH[:TOKEN]",
                   help="register a textual-inversion embedding (not ported "
                        "yet: ROADMAP A14)")
    p.add_argument("--clip_skip", type=int, default=0,
                   help="skip the last N CLIP layers when encoding")
    p.add_argument("--serve", action="store_true",
                   help="launch the web UI (not ported yet: ROADMAP A17)")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--share", action="store_true")
    p.add_argument("--micro-batch", dest="micro_batch", type=int, default=4,
                   help="coalesce up to N concurrent HTTP requests (serve "
                        "mode, not ported yet: ROADMAP A17)")
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
    p.add_argument("--scheduler", default=None,
                   choices=["ddim", "pndm", "unipc", "dpm", "euler",
                            "euler_a", "heun", "lms", "deis", "dpm_sde",
                            "lcm"],
                   help="sampler (default: ddim for v1, unipc for v2, the "
                        "only ones ported yet; ROADMAP A13 brings the rest)")
    p.add_argument("--control_type", default=None,
                   choices=[None, "canny", "depth", "hed", "pose"],
                   help="ControlNet conditioning (not ported yet: ROADMAP A12)")
    p.add_argument("--horizontal_expansion", type=float, default=1.0)
    p.add_argument("--vertical_expansion", type=float, default=1.0)
    p.add_argument("--short_side", type=int, default=640,
                   help="resize short side before inference (640 tasks / "
                        "512 outpaint in the reference)")
    p.add_argument("--tiny", action="store_true",
                   help="use the tiny test config (fast smoke runs)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the call to DIR")
    p.add_argument("--aot-cache", dest="aot_cache", default=None,
                   metavar="FILE",
                   help="cold-start executable cache (not ported yet: "
                        "ROADMAP A17)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cpu runs the kernels' "
                        "plain PyTorch versions)")
    return p


def unported(args, defaults) -> list:
    """One message per given option whose module is not ported yet."""
    out = []
    for flag, given, item in (
            ("--checkpoint_dir", args.checkpoint_dir, "A14"),
            ("--lora", args.lora, "A14"),
            ("--textual_inversion", args.textual_inversion, "A14"),
            ("--serve", args.serve, "A17"),
            ("--micro-batch", args.micro_batch != defaults.micro_batch, "A17"),
            ("--aot-cache", args.aot_cache, "A17"),
            ("--control_type", args.control_type, "A12")):
        if given:
            out.append(f"{flag} is not ported yet (ROADMAP {item})")
    ported = PORTED_SCHEDULER[args.version]
    if args.scheduler not in (None, ported):
        out.append(f"--scheduler {args.scheduler} is not ported yet for "
                   f"{args.version} (ROADMAP A13); it samples with {ported}")
    return out


def build_pipeline(args):
    """The random-weight demo stack of ``args.version``, full width or
    ``--tiny``, from seed 0, on ``args.device``."""
    import torch

    from powerpaint_tpu_torch.core.config import ppt_v1_config, ppt_v2_config
    from powerpaint_tpu_torch.io.weights import init_state
    from powerpaint_tpu_torch.testing import tiny_v1_config, tiny_v2_config
    from powerpaint_tpu_torch.text.tokenizer import (
        HashTokenizer,
        TokenizerWrapper,
        add_task_tokens,
    )

    dtype = torch.bfloat16 if args.weight_dtype == "bfloat16" else torch.float32
    v1 = args.version == "ppt-v1"
    if args.tiny:
        cfg = tiny_v1_config() if v1 else tiny_v2_config()
        vocab = 1024
    else:
        cfg = ppt_v1_config() if v1 else ppt_v2_config()
        vocab = 49408
    device = torch.device(args.device)
    state = init_state(cfg, torch.Generator(device=device).manual_seed(0),
                       device=device, dtype=dtype)
    tok = TokenizerWrapper(HashTokenizer(vocab_size=vocab))
    add_task_tokens(tok)
    if v1:
        from powerpaint_tpu_torch.pipelines.inpaint import InpaintPipeline

        return InpaintPipeline(cfg, state, tok, dtype=dtype, device=device)
    from powerpaint_tpu_torch.pipelines.brushnet import BrushNetPipeline

    return BrushNetPipeline(cfg, state, tok, dtype=dtype, device=device)


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
    kwargs = {}
    if args.scheduler is not None and args.version == "ppt-v2":
        kwargs["scheduler"] = args.scheduler

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
    print(f"wrote {args.output} ({final.shape[1]}x{final.shape[0]}) "
          f"in {dt:.1f}s ({args.steps} steps)")
    return 0


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    problems = unported(args, parser.parse_args([]))
    if problems:
        parser.error("; ".join(problems))
    return run_one_shot(args)


if __name__ == "__main__":
    sys.exit(main())
