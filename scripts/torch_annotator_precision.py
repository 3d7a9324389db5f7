#!/usr/bin/env python3
"""The annotator and safety-checker forwards on one NVIDIA GPU, by matmul and
convolution precision, against the same network on the CPU in fp32.

    python3 scripts/torch_annotator_precision.py

Each network of ``powerpaint_tpu_torch`` at its full published width, with
random weights from a seed, at its production input (DPT-hybrid at 384^2,
HED at 512^2, the body-pose network at a 512^2 image's 184 x 192, the CLIP
ViT-L/14 safety checker at 224^2), under four settings:

- ``exact``: TF32 off for cuBLAS and cuDNN, cuDNN's heuristics;
- ``exact+benchmark``: the same with ``cudnn.benchmark`` (cuDNN times its
  algorithms and keeps the fastest);
- ``default``: PyTorch's defaults, TF32 for cuDNN convolutions and exact
  fp32 matmuls (the port's setting);
- ``tf32``: TF32 for both.

For each: the device time of one forward (CUDA events around 5 forwards
after two warm-ups) and max |card - CPU| over the CPU output's largest
magnitude (the body-pose fields and the checker's projected embedding
concatenated); for DPT also the difference of the min/max-normalised uint8
depth maps. Then, in ``exact``, the DPT forward's five slowest modules (each
leaf module timed alone with CUDA events). Prints JSON lines, the card's
``nvidia-smi`` name and power limit first.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from powerpaint_tpu_torch.core import config as cfgs  # noqa: E402
from powerpaint_tpu_torch.io.weights import (  # noqa: E402
    load_annotator,
    random_annotator_state,
)
from powerpaint_tpu_torch.ops import _build  # noqa: E402

SETTINGS = {"exact": (False, False, False), "exact+benchmark": (False, False, True),
            "default": (False, True, False), "tf32": (True, True, False)}


def forward(family, model, x):
    if family == "bodypose":
        return torch.cat([f.flatten() for f in model(x)])
    if family == "safety_checker":
        return model.visual_projection(model.vision_model(x)[1])
    return model(x)


def depth_u8(d):
    d = (d - d.min()) / max(float(d.max() - d.min()), 1e-8)
    return (d * 255).clamp(0, 255).to(torch.uint8).int()


def slowest_modules(model, x, n=5):
    """(name, input shape, ms) of the n slowest leaf modules of one
    forward, each timed alone between synchronisations."""
    times, starts, hooks = [], {}, []

    def pre(mod, args):
        torch.cuda.synchronize()
        starts[mod] = torch.cuda.Event(enable_timing=True)
        starts[mod].record()

    def post(mod, args, out):
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        torch.cuda.synchronize()
        times.append((names[mod], list(args[0].shape), starts[mod].elapsed_time(end)))

    names = {m: n for n, m in model.named_modules() if not list(m.children())}
    for m in names:
        hooks += [m.register_forward_pre_hook(pre), m.register_forward_hook(post)]
    with torch.no_grad():
        model(x)
        times.clear()
        model(x)
    for h in hooks:
        h.remove()
    return sorted(times, key=lambda t: -t[2])[:n]


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    _build.build(("group_norm", "layer_norm"))
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(0)
    cases = {"dpt": (cfgs.dpt_hybrid_midas_config(), rng.rand(1, 384, 384, 3) * 2 - 1),
             "hed": (None, rng.rand(1, 512, 512, 3)),
             "bodypose": (None, rng.rand(1, 184, 192, 3) - 0.5),
             "safety_checker": (cfgs.safety_checker_config(),
                                rng.randn(1, 224, 224, 3))}
    for family, (config, x) in cases.items():
        state = random_annotator_state(family, torch.Generator().manual_seed(3),
                                       device="cpu", config=config)
        x = torch.as_tensor(x.astype(np.float32))
        with torch.no_grad():
            ref = forward(family, load_annotator(family, state, config=config,
                                                 device="cpu"), x).float()
        model = load_annotator(family, {k: v.to(dev) for k, v in state.items()},
                               config=config, device=dev)
        xd = x.to(dev)
        for name, (mm, conv, bench) in SETTINGS.items():
            torch.backends.cuda.matmul.allow_tf32 = mm
            torch.backends.cudnn.allow_tf32 = conv
            torch.backends.cudnn.benchmark = bench
            with torch.no_grad():
                for _ in range(2):
                    forward(family, model, xd)
                torch.cuda.synchronize()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                for _ in range(5):
                    out = forward(family, model, xd)
                end.record()
                torch.cuda.synchronize()
            out = out.float().cpu()
            err = float((out - ref).abs().max())
            scale = float(ref.abs().max())
            extra = {}
            if family == "dpt":
                du = (depth_u8(out) - depth_u8(ref)).abs()
                extra = dict(uint8_max=int(du.max()), uint8_mean=float(du.float().mean()))
            print(json.dumps(dict(family=family, setting=name,
                                  ms=start.elapsed_time(end) / 5, rel_err=err / scale,
                                  max_abs_err=err, scale=scale, **extra)), flush=True)
            if family == "dpt" and name == "exact":
                t0 = time.perf_counter()
                print(json.dumps(dict(family=family, setting=name, slowest_modules=[
                    dict(module=n, input=s, ms=t)
                    for n, s, t in slowest_modules(model, xd)],
                    seconds=time.perf_counter() - t0)), flush=True)
    torch.backends.cudnn.benchmark = False


if __name__ == "__main__":
    main()
