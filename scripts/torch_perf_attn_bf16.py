#!/usr/bin/env python3
"""The bf16-softmax flash attention experiment on one NVIDIA GPU: the port
of ``scripts/perf_attn_bf16.py``'s ``main``.

    python3 scripts/torch_perf_attn_bf16.py

Times the flash kernel (``flash_attention``, fp32 softmax) and its
bf16-softmax mode (``flash_attention_bf16_softmax``: scores, running max,
s - m and exp2 in bf16, p fed to p v as it comes) at the script's three
shapes, as (B, S, N, D): the UNet's first level under CFG (2, 4096, 8, 40),
its second (2, 1024, 8, 80) and a batch of eight images (16, 4096, 8, 40).
One JSON line a shape, the card's ``nvidia-smi`` name and power limit
first:

- ``*_ms`` of each: CUDA-graph device time of 20 calls (``chip_smoke.graph_ms``),
  and its TFLOP/s (4 B N S^2 D operations); for the mode also its time on
  the stream, its host time to enqueue and its plain version's time
  (``chip_smoke.cuda_ms`` / ``host_ms``);
- ``tensor_core_bound_ms`` (``chip_smoke.bound_ms``), ``exp2_floor_ms``
  (one MUFU.EX2 a score) and ``exp2_floor_packed_ms`` (two scores an op);
- ``sdpa_ms``: ``torch.nn.functional.scaled_dot_product_attention`` on the
  same inputs, which computes the fp32-softmax function (no PyTorch call
  computes the bf16 softmax);
- ``max_err_*``: each kernel's max |error| against dense fp32 softmax
  attention on a 2-head slice (batch 0, heads 0 and 1), as the TPU script
  measures it;
- ``vs_plain``: the mode against its plain version
  (``flash_attention_bf16_softmax_plain`` at the kernel's block of keys) on
  the whole input (``attention_errors`` and the share of equal elements),
  held to ``chip_smoke.BSM_RTOL``; ``control_b1_vs_plain``: B1's output
  against the same plain version, which must miss that bound; and
  ``vs_round_to_nearest_plain``: the mode against the plain version with
  p rounded to nearest instead of cut toward zero (the card's rounding).

Exits non-zero without a GPU, when the mode misses its plain version's
bound at any shape, or when B1 meets it.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from powerpaint_tpu_torch.ops import flash_attention as fa  # noqa: E402
from powerpaint_tpu_torch.parallel.dryrun import attention_errors  # noqa: E402

SHAPES = [(2, 4096, 8, 40), (2, 1024, 8, 80), (16, 4096, 8, 40)]


def errors(got: torch.Tensor, want: torch.Tensor) -> dict:
    """``attention_errors`` and the share of elements that are equal."""
    return dict(attention_errors(got, want),
                equal_share=float((got == want).float().mean()))


def exp2_nearest(x: torch.Tensor) -> torch.Tensor:
    return torch.exp2(x.float()).to(torch.bfloat16)


def measure(b: int, s: int, n: int, d: int, gen: torch.Generator) -> dict:
    dev = gen.device
    q, k, v = (torch.randn((b, s, n, d), generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    got = fa.flash_attention_bf16_softmax(q, k, v)
    want = fa.flash_attention_bf16_softmax_plain(q, k, v)
    vs_plain = errors(got, want)
    control = errors(fa.flash_attention(q, k, v), want)
    del want
    nearest = errors(got, fa.flash_attention_bf16_softmax_plain(q, k, v, exp2=exp2_nearest))
    # the TPU script's error measure: dense fp32 softmax on two heads
    sl = [x[:1, :, :2] for x in (q, k, v)]
    dense = fa.flash_attention_plain(*(x.float() for x in sl))
    errs = {name: float((fn(*sl).float() - dense).abs().max())
            for name, fn in (("max_err_flash_attention", fa.flash_attention),
                             ("max_err_bf16_softmax", fa.flash_attention_bf16_softmax))}
    del got, dense
    flops = 4.0 * b * n * s * s * d
    nbytes = 2.0 * 4 * b * s * n * d  # q, k, v read and the output written, bf16
    bound, bound_by = cs.bound_ms(flops, nbytes)
    mode = lambda: fa.flash_attention_bf16_softmax(q, k, v)  # noqa: E731
    ms = {"flash_attention": cs.graph_ms(lambda: fa.flash_attention(q, k, v)),
          "bf16_softmax": cs.graph_ms(mode)}
    row = dict(
        shape=[b, s, n, d], card=cs.CARD[0],
        flash_attention_ms=ms["flash_attention"], bf16_softmax_ms=ms["bf16_softmax"],
        bf16_softmax_stream_ms=cs.cuda_ms(mode), bf16_softmax_host_ms=cs.host_ms(mode),
        plain_ms=cs.cuda_ms(lambda: fa.flash_attention_bf16_softmax_plain(q, k, v),
                            iters=3),
        flash_attention_tflops=flops / ms["flash_attention"] / 1e9,
        bf16_softmax_tflops=flops / ms["bf16_softmax"] / 1e9,
        tensor_core_bound_ms=bound, bound_by=bound_by,
        exp2_floor_ms=cs.exp2_floor_ms(b * n * s * s),
        exp2_floor_packed_ms=cs.exp2_floor_ms(b * n * s * s / 2),
        sdpa_ms=cs.graph_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)),
        sdpa_scope="scaled_dot_product_attention: the fp32-softmax function",
        **errs, vs_plain=vs_plain, control_b1_vs_plain=control,
        vs_round_to_nearest_plain=nearest, rtol=cs.BSM_RTOL,
        ok=cs.bsm_within(vs_plain) and not cs.bsm_within(control))
    torch.cuda.empty_cache()
    return row


def main() -> list:
    if not torch.cuda.is_available():
        sys.exit("torch_perf_attn_bf16: needs an NVIDIA GPU")
    print(cs.read_card(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=torch.device("cuda", 0)).manual_seed(0)
    rows = []
    for shape in SHAPES:
        rows.append(measure(*shape, gen))
        print(json.dumps(rows[-1]), flush=True)
    bad = [r["shape"] for r in rows if not r["ok"]]
    if bad:
        sys.exit(f"torch_perf_attn_bf16: the mode misses its plain version's "
                 f"bound, or B1 meets it, at {bad}")
    return rows


if __name__ == "__main__":
    main()
