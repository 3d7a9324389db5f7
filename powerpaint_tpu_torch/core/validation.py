"""Input validation, raised before any device work with actionable
messages (the port's copy of the checks ``InpaintPipeline.__call__`` and
``BrushNetPipeline.__call__`` use)."""

from __future__ import annotations

import numpy as np

from powerpaint_tpu_torch.text.prompts import TASKS

OUTPUT_TYPES = ("uint8", "float32", "latent")


class InputValidationError(ValueError):
    pass


def check_image_mask(image: np.ndarray, mask: np.ndarray) -> None:
    if image.ndim != 3 or image.shape[-1] != 3:
        raise InputValidationError(
            f"image must be (H, W, 3), got {image.shape}"
        )
    if mask.ndim != 2:
        raise InputValidationError(f"mask must be (H, W), got {mask.shape}")
    if image.shape[:2] != mask.shape[:2]:
        raise InputValidationError(
            f"image {image.shape[:2]} and mask {mask.shape[:2]} sizes differ; "
            "resize the mask to the image first"
        )
    h, w = image.shape[:2]
    if h % 8 or w % 8:
        raise InputValidationError(
            f"height/width must be multiples of 8, got {h}x{w} "
            "(use tasks.preprocess.crop_to_multiple_of_8)"
        )


def check_clip_skip(clip_skip: int, num_hidden_layers: int) -> None:
    """The encoder captures layer ``L - clip_skip``; outside [0, L-1] the
    value would be silently ignored."""
    if not 0 <= int(clip_skip) <= num_hidden_layers - 1:
        raise InputValidationError(
            f"clip_skip must be in [0, {num_hidden_layers - 1}] for a "
            f"{num_hidden_layers}-layer text encoder, got {clip_skip}"
        )


def check_call_args(
    *,
    task: str,
    num_inference_steps: int,
    guidance_scale: float,
    strength: float = 1.0,
    fitting_degree: float = 1.0,
    control_guidance_start: float = 0.0,
    control_guidance_end: float = 1.0,
) -> None:
    if task not in TASKS:
        raise InputValidationError(f"unknown task {task!r}; one of {TASKS}")
    if not 1 <= num_inference_steps <= 1000:
        raise InputValidationError(
            f"num_inference_steps must be in [1, 1000], got {num_inference_steps}"
        )
    if guidance_scale < 0:
        raise InputValidationError(
            f"guidance_scale must be >= 0, got {guidance_scale}"
        )
    if not 0 < strength <= 1:
        raise InputValidationError(
            f"strength must be in (0, 1], got {strength}"
        )
    if not 0 <= fitting_degree <= 1:
        raise InputValidationError(
            f"fitting_degree must be in [0, 1], got {fitting_degree}"
        )
    if not 0 <= control_guidance_start <= control_guidance_end <= 1:
        raise InputValidationError(
            "need 0 <= control_guidance_start <= control_guidance_end <= 1, "
            f"got [{control_guidance_start}, {control_guidance_end}]"
        )


SCHEDULERS = ("unipc",)


def check_scheduler(name: str, num_steps: int) -> None:
    """The port's ppt-v2 pipeline samples with UniPC only; the JAX
    package's other samplers are ROADMAP item A13."""
    if not 1 <= int(num_steps) <= 1000:
        raise InputValidationError(
            f"num_inference_steps must be in [1, 1000], got {num_steps}"
        )
    if name.lower() not in SCHEDULERS:
        raise InputValidationError(
            f"scheduler {name!r} is not ported yet (ROADMAP A13); one of "
            f"{SCHEDULERS}"
        )


def check_output_type(output_type: str) -> None:
    """uint8 images, float32 images in [-1, 1], or undecoded latents."""
    if output_type not in OUTPUT_TYPES:
        raise InputValidationError(
            f"output_type must be uint8 | float32 | latent, got "
            f"{output_type!r}"
        )
