"""Per-stage timing and counters (the port of ``powerpaint_tpu/core/
metrics.py``), and a ``torch.profiler`` trace for the CLI's ``--profile``.

Stages are wall-clock spans on the host. A span that must include the
device's work ends where the caller has waited for it (the pipelines' stage
``generate`` ends after the result is copied to the host). ``Telemetry``
keeps counters (images generated, denoise steps run) beside the last call's
stages; ``PowerPaint.infer`` reports the stages as ``timings_ms``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from typing import Dict, List, Optional

logger = logging.getLogger("powerpaint_tpu_torch")


@dataclasses.dataclass
class StageTiming:
    name: str
    seconds: float


class Telemetry:
    """Per-call stage timings + counters."""

    def __init__(self):
        self.counters: Dict[str, float] = {}
        self.stages: List[StageTiming] = []

    def count(self, name: str, value: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.stages.append(StageTiming(name, dt))
            logger.debug("stage %s: %.1f ms", name, dt * 1000)

    def last_call_report(self) -> Dict[str, float]:
        return {s.name: round(s.seconds * 1000, 2) for s in self.stages}

    def reset_stages(self) -> None:
        self.stages = []


GLOBAL = Telemetry()


@contextlib.contextmanager
def torch_profile_trace(out_dir: Optional[str]):
    """Record the region with ``torch.profiler`` (host and, where there is a
    card, device activity) and write a Chrome trace under ``out_dir``; a
    no-op when ``out_dir`` is empty."""
    if not out_dir:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
