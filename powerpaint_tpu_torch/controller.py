"""PowerPaint facade, the task router (the port of
``powerpaint_tpu/controller.py``; reference ``PowerPaintController``,
app.py:83-543).

One object owning a loaded pipeline, with the reference's preprocessing
policy: aspect resize to 640 short side (512 for outpainting), %8 crop,
outpaint canvas construction, red-overlay visualization and blur-blend
compositing (app.py:245-473).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from powerpaint_tpu_torch.core.metrics import GLOBAL as telemetry
from powerpaint_tpu_torch.core.safety import apply_safety_checker
from powerpaint_tpu_torch.tasks.postprocess import blend_result, red_overlay
from powerpaint_tpu_torch.tasks.preprocess import (
    crop_from_bucket,
    crop_to_multiple_of_8,
    outpaint_canvas,
    pad_to_bucket,
    resize_short_side,
    to_numpy_image,
    to_numpy_mask,
)
from powerpaint_tpu_torch.text.prompts import OUTPAINTING


@dataclasses.dataclass
class InferenceResult:
    result: np.ndarray  # blur-blended composite (H, W, 3) uint8
    raw: np.ndarray  # raw model output
    mask_overlay: np.ndarray  # red-overlay visualization
    timings_ms: Dict[str, float]
    nsfw_flags: Optional[list] = None


class PowerPaint:
    """``infer()`` mirrors the reference controller's routing
    (app.py:475-543) for a ppt-v1 ``InpaintPipeline`` or a ppt-v2
    ``BrushNetPipeline``."""

    def __init__(self, pipeline):
        self.pipeline = pipeline

    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str, version: str = "ppt-v1",
                        dtype=None):
        raise NotImplementedError(
            "loading a checkpoint directory is not ported yet (ROADMAP A14); "
            "build a pipeline from a state dict and pass it to PowerPaint()")

    def infer(
        self,
        image,
        mask=None,
        *,
        task: str = "text-guided",
        prompt: str = "",
        negative_prompt: str = "",
        fitting_degree: float = 1.0,
        num_inference_steps: int = 45,
        guidance_scale: float = 7.5,
        seed: int = 0,
        control_type: Optional[str] = None,
        control_image=None,
        controlnet_conditioning_scale: float = 1.0,
        horizontal_expansion_ratio: float = 1.0,
        vertical_expansion_ratio: float = 1.0,
        short_side: int = 640,
        blend_blur_radius: float = 4.0,
        resolution_bucketing: bool = False,
        **pipeline_kwargs,
    ) -> InferenceResult:
        """``pipeline_kwargs`` pass through to the pipeline (strength= /
        eta= for v1, guess_mode= / brushnet_conditioning_scale= for v2).

        ``resolution_bucketing`` pads inputs to 64-pixel size buckets (edge
        pixels marked keep) and crops the result back, so a server sees
        few distinct shapes. ``control_type`` needs a ControlNet pipeline,
        which the port does not have yet (ROADMAP A12)."""
        if control_type is not None:
            raise ValueError(
                "control_type given but no ControlNet pipeline loaded "
                "(ControlNet is not ported yet: ROADMAP A12)")
        img = to_numpy_image(image)

        # reference resize policy: 640 short side for tasks, 512 for outpaint
        target = 512 if task == OUTPAINTING else short_side
        if min(img.shape[:2]) > target:
            img = resize_short_side(img, target)

        if task == OUTPAINTING:
            img, msk = outpaint_canvas(
                img, horizontal_expansion_ratio, vertical_expansion_ratio)
        else:
            if mask is None:
                raise ValueError(f"task {task!r} requires a mask")
            msk = to_numpy_mask(mask)
            if msk.shape[:2] != img.shape[:2]:
                msk = np.asarray(
                    resize_short_side((msk * 255).astype(np.uint8),
                                      min(img.shape[:2]))
                ).astype(np.float32) / 255.0
                msk = msk[: img.shape[0], : img.shape[1]]

        img = crop_to_multiple_of_8(img)
        msk = msk[: img.shape[0], : img.shape[1]]

        orig_hw = None
        if resolution_bucketing:
            img, msk, orig_hw = pad_to_bucket(img, msk)
            if orig_hw == img.shape[:2]:
                orig_hw = None

        out = self.pipeline(
            img, msk, prompt=prompt, negative_prompt=negative_prompt,
            task=task, fitting_degree=fitting_degree,
            num_inference_steps=num_inference_steps,
            guidance_scale=guidance_scale, seed=seed, **pipeline_kwargs)

        out, nsfw_flags = apply_safety_checker(out)
        result = blend_result(out[0], img, msk, blur_radius=blend_blur_radius)
        raw = out[0]
        overlay = red_overlay(img, msk)
        if orig_hw is not None:
            result = crop_from_bucket(result, orig_hw)
            raw = crop_from_bucket(raw, orig_hw)
            overlay = crop_from_bucket(overlay, orig_hw)
        return InferenceResult(
            result=result,
            raw=raw,
            mask_overlay=overlay,
            timings_ms=telemetry.last_call_report(),
            nsfw_flags=nsfw_flags,
        )
