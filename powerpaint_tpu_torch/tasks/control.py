"""Control-image preprocessors for the ControlNet path (the port's copy of
``powerpaint_tpu/tasks/control.py``'s registry and canny).

canny runs on the host through OpenCV with the reference thresholds
(100 / 200), imported when it is called, not when this module is. Depth,
HED and pose need their annotator networks, which the port does not have
yet (ROADMAP A15): ``get_control_image`` raises for them unless a
preprocessor was registered under their name.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

_REGISTRY: Dict[str, Callable[[np.ndarray], np.ndarray]] = {}
_ANNOTATORS = ("depth", "hed", "pose")


def register_preprocessor(name: str, fn: Callable[[np.ndarray], np.ndarray]):
    _REGISTRY[name] = fn


def canny(image: np.ndarray, low: int = 100, high: int = 200) -> np.ndarray:
    """cv2.Canny edges of an (H, W, 3) uint8 image, as (H, W, 3) uint8."""
    import cv2

    edges = cv2.Canny(image, low, high)
    return np.stack([edges] * 3, axis=-1)


register_preprocessor("canny", canny)


def get_control_image(control_type: str, image: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 control map of ``image`` for ``control_type``."""
    if control_type in _REGISTRY:
        return _REGISTRY[control_type](image)
    if control_type in _ANNOTATORS:
        raise NotImplementedError(
            f"control type {control_type!r} needs its annotator network, "
            "which is not ported yet (ROADMAP A15); register one with "
            "powerpaint_tpu_torch.tasks.control.register_preprocessor or "
            "pass control_image")
    raise NotImplementedError(
        f"unknown control type {control_type!r}; register one with "
        "powerpaint_tpu_torch.tasks.control.register_preprocessor"
        f" (available: {sorted(_REGISTRY)})")
