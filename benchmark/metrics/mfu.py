"""Percent of the card's bf16 peak (989 TFLOP/s) that the images completed
in the window amount to: their model FLOPs (``flops/<config>.<H>x<W>.json``,
torch's FLOP counter over the plain reference, at each request's canvas
and steps) over the window's seconds times the peak. Host clock, over the
untraced window, so the profiler's cost does not enter."""

from benchmark.flops import frozen, image_flops
from benchmark.work import PEAK_BF16_FLOPS


def read(run):
    w = run.main
    done = w.completed()
    if not done:
        return None
    total = sum(image_flops(frozen(run.config_name, r.canvas), r.steps) for r in done)
    return 100.0 * total / (w.length * PEAK_BF16_FLOPS)
