"""The arithmetic of the end-to-end metrics, over every request of a window.

A request is (sent time, done time, ok), on the host's monotonic clock.
It counts as completed in the window (t0, t1] when it succeeded and its
image came to the client's hands after the window opened and by its end,
whenever it was sent.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple


def completed(requests: Iterable[Tuple[float, float, bool]], t0: float,
              t1: float) -> List[Tuple[float, float, bool]]:
    return [r for r in requests if r[2] and t0 < r[1] <= t1]


def rate(requests, t0: float, t1: float) -> float:
    """Images completed in (t0, t1] per second of the window."""
    return len(completed(requests, t0, t1)) / (t1 - t0)


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank q-th percentile: the smallest value with at least
    q percent of the values at or below it."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    k = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[k - 1]


def latency_percentile(requests, t0: float, t1: float, q: float) -> float:
    """The q-th percentile of the latency, sent to image, of every
    request completed in the window."""
    return percentile([done - sent for sent, done, _ in completed(requests, t0, t1)], q)

