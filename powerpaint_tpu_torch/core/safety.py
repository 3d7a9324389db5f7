"""Safety-checker hook (the hook part of ``powerpaint_tpu/core/safety.py``).

The checker is a callable ``images_uint8 -> list[bool]`` (True = flagged).
Flagged images are blacked out, as the reference pipeline does.
``register_safety_checker`` installs a process-wide default; a deployment
supplies its own model. The CLIP-based checker itself is ROADMAP A15.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

SafetyChecker = Callable[[np.ndarray], List[bool]]

_CHECKER: Optional[SafetyChecker] = None


def register_safety_checker(fn: Optional[SafetyChecker]) -> None:
    global _CHECKER
    _CHECKER = fn


def get_safety_checker() -> Optional[SafetyChecker]:
    return _CHECKER


def apply_safety_checker(images: np.ndarray,
                         checker: Optional[SafetyChecker] = None):
    """(images, has_nsfw_flags): flagged images are zeroed (black)."""
    checker = checker if checker is not None else _CHECKER
    if checker is None:
        return images, [False] * images.shape[0]
    flags = list(checker(images))
    out = images.copy()
    for i, bad in enumerate(flags):
        if bad:
            out[i] = 0
    return out, flags
