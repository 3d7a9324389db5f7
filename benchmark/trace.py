"""The device trace of a traced run: ``torch.profiler`` recording the card's
activity alone (CUPTI's kernel, copy and set records), reduced to device
intervals on the host's clock.

The two clocks are aligned on a marker: after the profiler starts and the
card is idle, one short kernel is launched and waited for; the host's
clock read after the wait, less the marker's end in the trace, is the
offset (the wait's own latency, some microseconds, is the error).
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import torch

Interval = Tuple[float, float]


def _ns(event, end: bool) -> int:
    return int(event.end_ns() if end else event.start_ns())


class DeviceTrace:
    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._marker_host_ns = None

    def start(self) -> None:
        self._prof.start()
        torch.cuda.synchronize()
        torch.cuda._sleep(1 << 20)
        torch.cuda.synchronize()
        self._marker_host_ns = time.perf_counter_ns()

    def stop(self) -> None:
        self._prof.stop()

    def events(self) -> List[Tuple[str, float, float]]:
        """(name, start s, end s) of every device activity after the
        marker, on the host's ``perf_counter`` clock."""
        raw = [e for e in self._prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA]
        raw.sort(key=lambda e: _ns(e, False))
        if not raw:
            return []
        offset = self._marker_host_ns - _ns(raw[0], True)
        return [(e.name(), (_ns(e, False) + offset) / 1e9, (_ns(e, True) + offset) / 1e9)
                for e in raw[1:]]


def clip(events, t0: float, t1: float):
    return [(n, max(s, t0), min(e, t1)) for n, s, e in events if e > t0 and s < t1]


def union(intervals: Sequence[Interval]) -> List[Interval]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_s(events, t0: float, t1: float) -> float:
    return sum(e - s for s, e in union([(s, e) for _, s, e in clip(events, t0, t1)]))


def time_by_name(events, t0: float, t1: float) -> Dict[str, float]:
    out: Dict[str, float] = defaultdict(float)
    for n, s, e in clip(events, t0, t1):
        out[n] += e - s
    return dict(out)


def gaps(events, t0: float, t1: float) -> List[Interval]:
    """The idle intervals of [t0, t1]: no device activity running."""
    out, at = [], t0
    for s, e in union([(s, e) for _, s, e in clip(events, t0, t1)]):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if at < t1:
        out.append((at, t1))
    return out


# what the host was doing, most telling first
HOST_SPANS = ("dispatch", "collect", "fetch", "client")


def label(gap: Interval, spans: Dict[str, List[Interval]]) -> str:
    """The benchmark's host span open at the gap's middle, by
    ``HOST_SPANS`` order, or "none"."""
    mid = (gap[0] + gap[1]) / 2
    for name in HOST_SPANS:
        if any(s <= mid <= e for s, e in spans.get(name, ())):
            return name
    return "none"


def breakdown(events, spans, t0: float, t1: float, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by what
    the host was doing (the sum of each label's gaps, then the longest
    single gaps), each at most ``top`` entries, in seconds."""
    ops = sorted(time_by_name(events, t0, t1).items(), key=lambda kv: -kv[1])[:top]
    labelled = [(label(g, spans), g) for g in gaps(events, t0, t1)]
    totals: Dict[str, float] = defaultdict(float)
    for name, (s, e) in labelled:
        totals[name] += e - s
    idle = [[f"all idle while {k}", v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])]
    longest = sorted(labelled, key=lambda lg: lg[1][0] - lg[1][1])
    idle += [[f"{k} gap at +{s - t0:.3f} s", e - s] for k, (s, e) in longest]
    return {"device_ops": [[n[:160], t] for n, t in ops], "idle_gaps": idle[:top]}
