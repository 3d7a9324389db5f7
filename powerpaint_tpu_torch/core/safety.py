"""Safety checker: the hook and the CLIP-based checker (the port of
``powerpaint_tpu/core/safety.py``).

The checker is a callable ``images_uint8 -> list[bool]`` (True = flagged).
Flagged images are blacked out, as the reference pipeline does.
``register_safety_checker`` installs a process-wide default;
``CLIPSafetyChecker`` is the published one (CLIP ViT-L/14 with concept
thresholds, ``models/clip_vision.py``) as such a callable.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

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


# CLIP normalisation (transformers CLIPImageProcessor defaults)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


class CLIPSafetyChecker:
    """The CLIP checker as a registrable hook: PIL bicubic resize of each
    uint8 image to the tower's input size, CLIP normalisation, then
    ``StableDiffusionSafetyChecker`` on ``device`` in fp32; returns the
    per-image flags.

    ``state``: a state dict with diffusers ``StableDiffusionSafetyChecker``
    names (``vision_model.vision_model.*``, ``visual_projection.weight``,
    the concept tables and their thresholds), or ``checkpoint`` a local
    file of one."""

    def __init__(self, config, state=None, checkpoint: Optional[str] = None,
                 device="cuda"):
        from powerpaint_tpu_torch.io.weights import load_annotator

        self.config = config
        self.device = torch.device(device)
        self.model = load_annotator("safety_checker", state,
                                    checkpoint=checkpoint, config=config,
                                    device=self.device)

    def preprocess(self, images: np.ndarray) -> np.ndarray:
        """(N, H, W, 3) uint8 -> (N, S, S, 3) float32 CLIP pixels."""
        from PIL import Image

        s = self.config.image_size
        batch = np.stack([
            np.asarray(Image.fromarray(img).resize((s, s), Image.BICUBIC),
                       dtype=np.float32)
            for img in images])
        return (batch / 255.0 - CLIP_MEAN) / CLIP_STD

    @torch.no_grad()
    def __call__(self, images: np.ndarray) -> List[bool]:
        x = torch.as_tensor(self.preprocess(images), device=self.device)
        return [bool(f) for f in self.model(x).cpu().numpy()]
