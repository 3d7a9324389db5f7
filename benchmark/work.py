"""The yardstick of the kernel metrics: the card's published peaks, the least
time the card could take for a piece of work, and the operations and bytes
that a served request's sites need, worked out from the configuration's
shapes (the served system's kernels and how they split the work do not
enter).

Peaks: NVIDIA H100 SXM data sheet, dense, at the 700 W power limit: 989
TFLOP/s bf16 on the tensor cores, 3.35 TB/s of HBM3. A roofline bound is the
larger of operations over the operation peak and bytes over the memory
rate, each input byte counted read once and each output byte written once,
bf16 (2 bytes) activations and weights.

Sites follow the method of the repository's ``chip_smoke.unet_sites`` /
``vae_sites``:

- conv: every stride-1 3x3 convolution of a ResNet unit (its conv1 and
  conv2, which the GroupNorm + SiLU before it feeds) and of an upsampler,
  in the UNet, the BrushNet branch and the VAE; (H, W, Cin, Cout) at the
  batch that runs it;
- attention: every self- and cross-attention of the UNet's and the
  branch's transformers (heads from the configuration, 77 text tokens),
  and the VAE's one-head mid attention in the encoder and the decoder.
"""

from __future__ import annotations

import sys
from typing import List, Tuple

from benchmark.trace import clip

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
BYTES = 2
TEXT_TOKENS = 77


def bound_s(flops: float, nbytes: float) -> Tuple[float, str]:
    """(least seconds, "operations" or "bytes": the bound that applies)."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _half(n: int) -> int:
    return -(-n // 2)


def unet_levels(u: dict, h: int, w: int) -> List[Tuple[int, int]]:
    sizes = [(h, w)]
    for _ in range(len(u["block_out_channels"]) - 1):
        sizes.append((_half(sizes[-1][0]), _half(sizes[-1][1])))
    return sizes


def unet_conv_sites(u: dict, h: int, w: int) -> List[Tuple[int, int, int, int]]:
    """(H, W, Cin, Cout) of each ResNet conv and upsampler conv of one UNet
    (or BrushNet branch: the same blocks) evaluation on an h x w latent."""
    ch, per = list(u["block_out_channels"]), u["layers_per_block"]
    n = len(ch)
    sizes = unet_levels(u, h, w)
    sites = []

    def unit(hw, cin, cout):
        sites.extend([(*hw, cin, cout), (*hw, cout, cout)])

    skips, prev = [ch[0]], ch[0]
    for i in range(n):
        for _ in range(per):
            unit(sizes[i], prev, ch[i])
            prev = ch[i]
            skips.append(ch[i])
        if i < n - 1:
            skips.append(ch[i])
    unit(sizes[-1], ch[-1], ch[-1])
    unit(sizes[-1], ch[-1], ch[-1])
    rev = ch[::-1]
    prev = rev[0]
    for i in range(n):
        for _ in range(per + 1):
            unit(sizes[n - 1 - i], prev + skips.pop(), rev[i])
            prev = rev[i]
        if i < n - 1:
            sites.append((*sizes[n - 2 - i], rev[i], rev[i]))
    return sites


def vae_conv_sites(v: dict, h: int, w: int, decoder: bool) -> List[Tuple[int, int, int, int]]:
    """The same for one VAE encode of an h x w image or decode to one."""
    ch, per = list(v["block_out_channels"]), v["layers_per_block"]
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
            if i < n - 1:
                sites.append((*sizes[n - 2 - i], rev[i], rev[i]))
    return sites


def conv_work(batch: int, site) -> Tuple[float, float]:
    hh, ww, cin, cout = site
    flops = 2.0 * batch * hh * ww * cin * cout * 9
    nbytes = BYTES * (batch * hh * ww * (cin + cout) + 9 * cin * cout + cout)
    return flops, nbytes


def unet_attention_sites(u: dict, h: int, w: int) -> List[Tuple[int, int, int, int]]:
    """(Sq, Skv, heads, head dim) of each attention of one UNet evaluation."""
    ch, per = list(u["block_out_channels"]), u["layers_per_block"]
    heads, layers = u["attention_head_dim"], u["transformer_layers_per_block"]
    sizes = unet_levels(u, h, w)
    n = len(ch)
    levels = []
    for i, kind in enumerate(u["down_block_types"]):
        if kind.startswith("CrossAttn"):
            levels += [i] * per
    levels.append(n - 1)  # the mid block
    for i, kind in enumerate(u["up_block_types"]):
        if kind.startswith("CrossAttn"):
            levels += [n - 1 - i] * (per + 1)
    sites = []
    for lv in levels:
        s = sizes[lv][0] * sizes[lv][1]
        d = ch[lv] // heads
        sites += [(s, s, heads, d), (s, TEXT_TOKENS, heads, d)] * layers
    return sites


def vae_attention_sites(v: dict, h: int, w: int) -> List[Tuple[int, int, int, int]]:
    """The VAE's mid attention on an h x w image (one head, all channels)."""
    s = (h >> (len(v["block_out_channels"]) - 1)) * (w >> (len(v["block_out_channels"]) - 1))
    return [(s, s, 1, v["block_out_channels"][-1])]


def attention_work(batch: int, site) -> Tuple[float, float]:
    sq, skv, heads, d = site
    flops = 4.0 * batch * heads * sq * skv * d
    nbytes = BYTES * batch * heads * d * (2 * sq + 2 * skv)
    return flops, nbytes


def request_sites(config: dict, canvas, steps: int, batch: int, kind: str):
    """[(batch, site)] of one served call of ``batch`` images: the text
    encode aside, the VAE encode of the masked image, ``steps`` evaluations
    of the UNet (and of the BrushNet branch) under CFG (2 x batch), and the
    decode. ``kind``: "conv" or "attention"."""
    h, w = canvas
    lh, lw = h // 8, w // 8
    u, v = config["unet"], config["vae"]
    if kind == "conv":
        net, vae = unet_conv_sites, lambda dec: vae_conv_sites(v, h, w, dec)
    else:
        net, vae = unet_attention_sites, lambda dec: vae_attention_sites(v, h, w)
    per_step = net(u, lh, lw)
    if config.get("brushnet") is not None:
        per_step = per_step + net(config["brushnet"]["base"], lh, lw)
    return ([(batch, s) for s in vae(False)]
            + [(2 * batch, s) for s in per_step] * steps
            + [(batch, s) for s in vae(True)])


def call_bound_s(config: dict, canvas, steps: int, batch: int, kind: str) -> Tuple[float, dict]:
    """Least seconds for one call's ``kind`` work, summed site by site, and
    how much of it each bound set ({"operations": s, "bytes": s})."""
    fn = conv_work if kind == "conv" else attention_work
    total, by = 0.0, {"operations": 0.0, "bytes": 0.0}
    for b, site in request_sites(config, canvas, steps, batch, kind):
        t, which = bound_s(*fn(b, site))
        total += t
        by[which] += t
    return total, by


def roofline_share(run, kind: str, mark: str):
    """A kernel family's share of its roofline in the traced window, in
    percent: the least time the card could take for the ``kind`` work of
    the batches completed in the window, over the device time of the
    kernels whose names hold ``mark``. None where there is nothing to read
    (no trace, or no such kernel ran)."""
    w = run.traced
    if w is None or w.events is None:
        return None
    kernel_s = sum(e - s for n, s, e in clip(w.events, w.t0, w.t1) if mark in n)
    if kernel_s <= 0:
        return None
    bound, by = 0.0, {"operations": 0.0, "bytes": 0.0}
    for b in w.batches_in():
        t, split = call_bound_s(run.config, b.canvas, b.steps, b.size, kind)
        bound += t
        for k in by:
            by[k] += split[k]
    print(f"{mark} roofline: bound {bound:.4f} s ({by['operations']:.4f} s by operations, "
          f"{by['bytes']:.4f} s by bytes) over {kernel_s:.4f} s of kernels", file=sys.stderr)
    return 100.0 * bound / kernel_s
