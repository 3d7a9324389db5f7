"""Percent of the traced window in which no operation ran on the card:
100 minus the union of the device's kernel, copy and set intervals. The
traced window pays the profiler's cost on the host, which a host-paced
cell shows as idle."""

from benchmark.trace import busy_s


def read(run):
    w = run.traced
    if w is None or w.events is None:
        return None
    return 100.0 * (1.0 - busy_s(w.events, w.t0, w.t1) / w.length)
