"""Model FLOPs of a served image, for ``mfu``.

``torch.utils.flop_counter`` over the plain reference's modules on meta
tensors gives the operations of each stage of one request at a canvas:
one CFG evaluation (batch 2) of the UNet and of the BrushNet branch, the
VAE encode and decode of one image, and the text towers' encode of one
request's prompts (4 task rows; ppt-v2 also 2 plain rows). They are frozen
in ``flops/<config>.<H>x<W>.json``, so ``mfu`` reads the same however the
served system computes; ``python -m benchmark.flops`` writes them, and a
test holds the frozen files to a new count.

Per image: steps x (UNet + branch) + encode + decode + text.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.weights import families_on_meta

ROOT = Path(__file__).resolve().parent


def count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def stage_flops(config: dict, canvas) -> dict:
    h, w = canvas
    m = families_on_meta(config)
    meta = dict(device="meta")
    lat = (2, config["vae"]["latent_channels"], h // 8, w // 8)
    ctx = torch.zeros(2, 77, config["unet"]["cross_attention_dim"], **meta)
    t = torch.zeros((), dtype=torch.long, **meta)
    ids4 = torch.zeros(4, 77, dtype=torch.long, **meta)
    u = config["unet"]
    out = {
        "unet_cfg_evaluation": count(lambda: m["unet"](
            torch.zeros(2, u["in_channels"], *lat[2:], **meta), t, ctx)),
        "vae_encode": count(lambda: m["vae"].encode(torch.zeros(1, 3, h, w, **meta))),
        "vae_decode": count(lambda: m["vae"].decode(torch.zeros(1, *lat[1:], **meta))),
    }
    if config.get("brushnet") is None:
        out["text_encode"] = count(lambda: m["text_encoder"](ids4))
        return out
    bn = config["brushnet"]
    cond = torch.zeros(2, bn["conditioning_channels"], *lat[2:], **meta)
    out["brushnet_cfg_evaluation"] = count(lambda: m["brushnet"](
        torch.zeros(2, bn["base"]["in_channels"], *lat[2:], **meta), t, ctx, cond))
    out["text_encode"] = (count(lambda: m["text_encoder_brushnet"](ids4))
                          + count(lambda: m["text_encoder"](ids4[:2])))
    return out


def image_flops(stages: dict, steps: int) -> float:
    per_step = stages["unet_cfg_evaluation"] + stages.get("brushnet_cfg_evaluation", 0)
    return float(steps * per_step + stages["vae_encode"] + stages["vae_decode"]
                 + stages["text_encode"])


def path(config_name: str, canvas) -> Path:
    return ROOT / "flops" / f"{config_name}.{canvas[0]}x{canvas[1]}.json"


def frozen(config_name: str, canvas) -> dict:
    return json.loads(path(config_name, canvas).read_text())


def main(argv) -> None:
    """``python -m benchmark.flops <config name> <H> <W>``: write the frozen
    count of that configuration's file at that canvas."""
    name, h, w = argv[0], int(argv[1]), int(argv[2])
    config = json.loads((ROOT / "configs" / f"{name}.json").read_text())["config"]
    stages = stage_flops(config, (h, w))
    path(name, (h, w)).write_text(json.dumps(stages, indent=1) + "\n")
    print(json.dumps(stages))


if __name__ == "__main__":
    main(sys.argv[1:])
