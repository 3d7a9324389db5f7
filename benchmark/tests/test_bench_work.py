"""The roofline and MFU work counts against ``torch.utils.flop_counter`` on
meta tensors, on the CPU."""

import json
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops, work
from benchmark.weights import families_on_meta

ROOT = Path(__file__).resolve().parents[1]
FROZEN = sorted(p.name for p in (ROOT / "flops").glob("*.json"))


def config(name):
    return json.loads((ROOT / "configs" / f"{name}.json").read_text())["config"]


@pytest.mark.parametrize("frozen", FROZEN)
def test_frozen_flops_are_a_fresh_count(frozen):
    name, hw, _ = frozen.rsplit(".", 2)
    h, w = (int(x) for x in hw.split("x"))
    assert flops.stage_flops(config(name), (h, w)) == flops.frozen(name, (h, w))


def _by_module(fn):
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_flop_counts()


def _sum(counts, suffixes, op_names):
    """FLOPs of the leaf modules whose names end with one of ``suffixes``,
    in the ops named ``op_names``."""
    total = 0
    for mod, ops in counts.items():
        if mod.endswith(suffixes):
            total += sum(v for op, v in ops.items() if str(op).split(".")[1] in op_names)
    return total


@pytest.mark.parametrize("name,canvas", [("ppt-v1", (512, 512)), ("ppt-v2", (512, 512)),
                                          ("ppt-v1", (768, 768))])
def test_site_work_is_what_the_counter_counts(name, canvas):
    cfg = config(name)
    m = families_on_meta(cfg)
    h, w = canvas
    u = cfg["unet"]
    meta = dict(device="meta")
    x = torch.zeros(2, u["in_channels"], h // 8, w // 8, **meta)
    ctx = torch.zeros(2, 77, u["cross_attention_dim"], **meta)
    counts = _by_module(lambda: m["unet"](x, torch.zeros((), dtype=torch.long, **meta), ctx))
    conv = sum(work.conv_work(2, s)[0] for s in work.unet_conv_sites(u, h // 8, w // 8))
    assert _sum(counts, (".conv1", ".conv2", "upsamplers.0.conv"), ("convolution",)) == conv
    attn = sum(work.attention_work(2, s)[0] for s in work.unet_attention_sites(u, h // 8, w // 8))
    assert _sum(counts, (".attn1", ".attn2"), ("bmm",)) == attn
    v = cfg["vae"]
    img = torch.zeros(1, 3, h, w, **meta)
    for dec, fn in ((False, lambda: m["vae"].encode(img)),
                    (True, lambda: m["vae"].decode(torch.zeros(1, 4, h // 8, w // 8, **meta)))):
        counts = _by_module(fn)
        conv = sum(work.conv_work(1, s)[0] for s in work.vae_conv_sites(v, h, w, dec))
        assert _sum(counts, (".conv1", ".conv2", "upsamplers.0.conv"), ("convolution",)) == conv
        attn = sum(work.attention_work(1, s)[0] for s in work.vae_attention_sites(v, h, w))
        assert _sum(counts, ("attentions.0",), ("bmm",)) == attn


def test_a_bound_is_the_larger_of_operations_and_bytes():
    t, which = work.bound_s(989e12, 1.0)
    assert which == "operations" and t == pytest.approx(1.0)
    t, which = work.bound_s(1.0, 3.35e12)
    assert which == "bytes" and t == pytest.approx(1.0)


def test_image_flops_add_the_stages():
    stages = flops.frozen("ppt-v2", (512, 512))
    per_step = stages["unet_cfg_evaluation"] + stages["brushnet_cfg_evaluation"]
    assert flops.image_flops(stages, 20) == pytest.approx(
        20 * per_step + stages["vae_encode"] + stages["vae_decode"] + stages["text_encode"])
    # about 68.9 TFLOP a ppt-v2 image at 20 steps
    assert flops.image_flops(stages, 20) == pytest.approx(68.9e12, rel=0.01)
