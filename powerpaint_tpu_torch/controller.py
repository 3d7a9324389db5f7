"""PowerPaint facade, the task router (the port of
``powerpaint_tpu/controller.py``; reference ``PowerPaintController``,
app.py:83-543).

One object owning the loaded pipelines, routing (task, control_type) to
the right one with the reference's preprocessing policy: aspect resize to
640 short side (512 for outpainting), %8 crop, outpaint canvas
construction, red-overlay visualization and blur-blend compositing
(app.py:245-473).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from powerpaint_tpu_torch.core.metrics import GLOBAL as telemetry
from powerpaint_tpu_torch.core.validation import InputValidationError
from powerpaint_tpu_torch.core.safety import apply_safety_checker
from powerpaint_tpu_torch.tasks.control import get_control_image
from powerpaint_tpu_torch.tasks.postprocess import blend_result, red_overlay
from powerpaint_tpu_torch.tasks.preprocess import (
    crop_from_bucket,
    crop_to_multiple_of_8,
    outpaint_canvas,
    pad_to_bucket,
    resize_short_side,
    resize_to,
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
    ``BrushNetPipeline``, and for a ``ControlNetPipeline`` given as
    ``controlnet_pipeline``, which takes the calls with a
    ``control_type``."""

    def __init__(self, pipeline, controlnet_pipeline=None):
        self.pipeline = pipeline
        self.controlnet_pipeline = controlnet_pipeline

    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str, version: str = "ppt-v1",
                        dtype=None, controlnet_dir: Optional[str] = None,
                        **kwargs):
        """A controller over the pipeline of a reference-layout checkpoint
        directory (or, for ppt-v1, an original-SD single file), linear and
        conv weights in ``dtype`` (bf16 by default). ``kwargs`` go to
        ``io.checkpoint.load_ppt_v1`` / ``load_ppt_v2``: ``device`` (the
        card unless ``"cpu"`` is asked for), ``int8``, ``config``.
        ``controlnet_dir`` (ppt-v1 only, as the reference offers ControlNet):
        a diffusers ControlNet directory (``io.checkpoint.load_controlnet``),
        whose branch over the loaded ppt-v1 models is the
        ``controlnet_pipeline``."""
        import torch

        from powerpaint_tpu_torch.io.checkpoint import (
            load_controlnet,
            load_ppt_v1,
            load_ppt_v2,
        )

        loaders = {"ppt-v1": load_ppt_v1, "ppt-v2": load_ppt_v2}
        if version not in loaders:
            raise ValueError(f"version {version!r}: one of {sorted(loaders)}")
        if controlnet_dir is not None and version != "ppt-v1":
            raise ValueError("controlnet_dir needs version 'ppt-v1': the "
                             "ControlNet branch conditions the ppt-v1 UNet")
        dtype = dtype or torch.bfloat16
        pipe = loaders[version](checkpoint_dir, dtype=dtype, **kwargs)
        if controlnet_dir is None:
            return cls(pipe)
        from powerpaint_tpu_torch.pipelines.controlnet import ControlNetPipeline

        branch = load_controlnet(controlnet_dir, dtype=dtype,
                                 device=kwargs.get("device", "cuda"),
                                 int8=kwargs.get("int8"))
        return cls(pipe, ControlNetPipeline.from_pipeline(pipe, branch))

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
        """``pipeline_kwargs`` pass through to the routed pipeline
        (scheduler= for all three, strength= / eta= for v1, guess_mode= /
        brushnet_conditioning_scale= / ip_adapter_image= /
        ip_adapter_image_embeds= / ip_adapter_scale= for v2, per-branch lists and
        control_guidance_start= / _end= for the ControlNet pipeline).

        ``resolution_bucketing`` pads inputs to 64-pixel size buckets (edge
        pixels marked keep) and crops the result back, so a server sees
        few distinct shapes. ``control_type`` routes the call to the
        ControlNet pipeline, with ``control_image`` or, when none is given,
        ``tasks.control.get_control_image`` of the preprocessed image,
        resized to the image where the preprocessor gives another size.

        A caller's ``control_image`` at the processed image's size passes as
        it is; at the input image's size it goes through the image's own
        resize (the same filter), outpainting canvas, crop and bucket pad
        (edge pixels replicated, as the image's), so it stays aligned with
        the image; at any other size the call is refused."""
        img = to_numpy_image(image)
        in_hw = img.shape[:2]

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

        kwargs = dict(
            prompt=prompt, negative_prompt=negative_prompt, task=task,
            fitting_degree=fitting_degree,
            num_inference_steps=num_inference_steps,
            guidance_scale=guidance_scale, seed=seed, **pipeline_kwargs)
        if control_type is not None:
            if self.controlnet_pipeline is None:
                raise ValueError(
                    "control_type given but no ControlNet pipeline loaded")
            if control_image is None:
                control_image = np.asarray(get_control_image(control_type, img))
                if control_image.shape[:2] != img.shape[:2]:
                    # a preprocessor's own output size (depth's is 1024^2):
                    # to the image's, as the reference pipelines resize a
                    # control image to the call's height and width
                    control_image = resize_to(control_image, None,
                                              *img.shape[:2])[0]
            else:
                control_image = _align_control(
                    to_numpy_image(control_image), in_hw, img.shape[:2],
                    lambda x: _like_image(
                        x, target, task, horizontal_expansion_ratio,
                        vertical_expansion_ratio, resolution_bucketing))
            out = self.controlnet_pipeline(
                img, msk, control_image=np.asarray(control_image),
                controlnet_conditioning_scale=controlnet_conditioning_scale,
                **kwargs)
        else:
            out = self.pipeline(img, msk, **kwargs)

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


def _like_image(x: np.ndarray, target: int, task: str, h_ratio: float,
                v_ratio: float, bucketing: bool) -> np.ndarray:
    """An (H, W, 3) uint8 array at the input image's size through the
    image's own steps in ``PowerPaint.infer``: the short-side resize,
    the outpainting canvas, the crop to multiples of 8 and the bucket
    pad."""
    if min(x.shape[:2]) > target:
        x = resize_short_side(x, target)
    if task == OUTPAINTING:
        x = outpaint_canvas(x, h_ratio, v_ratio)[0]
    x = crop_to_multiple_of_8(x)
    if bucketing:
        x = pad_to_bucket(x, np.zeros(x.shape[:2], np.float32))[0]
    return x


def _align_control(control: np.ndarray, in_hw, hw, like_image) -> np.ndarray:
    """A caller's control map for the processed image of size ``hw``: as
    it is at that size, through ``like_image`` at the input image's size
    ``in_hw``, refused at any other."""
    if control.shape[:2] == tuple(hw):
        return control
    if control.shape[:2] == tuple(in_hw):
        return like_image(control)
    raise InputValidationError(
        f"control image {tuple(control.shape[:2])} matches neither the input "
        f"image {tuple(in_hw)} nor the processed image {tuple(hw)}")
