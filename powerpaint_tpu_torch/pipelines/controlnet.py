"""ppt-v1 + ControlNet pipeline (canny / depth / HED / pose conditioned).

The port of ``powerpaint_tpu/pipelines/controlnet.py`` on PyTorch: the v1
pipeline (``pipelines.inpaint``) with, at every step, one ControlNet
forward per branch on the noisy latent and its control image, whose 12
down and 1 mid residuals are summed over the branches in order and added
onto the base UNet's skip connections and mid block (``models.unet``).

- Control images are ``uint8 / 255``, in [0, 1], not [-1, 1], and are
  doubled for classifier-free guidance like the latents.
- Each branch has its own conditioning scale and guidance window
  (``control_guidance_start`` / ``_end``), gated per executed step (after
  the strength truncation) through a host table of scales; every branch
  runs at every step, with scale 0 outside its window, as in the JAX
  package. A sampler with two evaluations a step (heun) reads its step's
  row at both (``pipelines.common.per_iteration``).
- Guess mode: the branches see only the conditional half (its text
  context and the undoubled control image); the unconditional half gets
  zero residuals.
- ``control_image=None`` is the plain v1 call (the reference's
  ``predict_woControl``).
- ``prompt_embeds``, ``callback`` and ``height`` / ``width`` as on the v1
  pipeline; ``height`` / ``width`` resize the control images with the
  image (LANCZOS), so the conditioning embedding lands on the same latent
  grid.
- The sampler is any of the registry's (``scheduler=``, DDIM by
  default), as on the v1 pipeline; the branches see the sampler's scaled
  latents, as the UNet does.

Randomness is the v1 pipeline's: per-image ``torch.Generator`` draws in the
v1 order, handed to ``_generate`` as tensors with the gating table, so a
test can inject the JAX package's threefry streams.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from powerpaint_tpu_torch.core.config import PowerPaintConfig
from powerpaint_tpu_torch.core.validation import (
    InputValidationError,
    check_control_image,
    check_scheduler,
)
from powerpaint_tpu_torch import schedulers
from powerpaint_tpu_torch.pipelines.common import (
    apply_target_hw,
    as_list,
    cond_scale_table,
    per_iteration,
    table_row,
    to_device,
)
from powerpaint_tpu_torch.pipelines.inpaint import InpaintPipeline
from powerpaint_tpu_torch.tasks.preprocess import resize_to, to_numpy_image


def _per_branch(value, n: int, name: str) -> list:
    values = as_list(value, n)
    if len(values) != n:
        raise InputValidationError(
            f"{name} must be a scalar or a length-{n} list")
    return values


def _zero_pad(x: torch.Tensor) -> torch.Tensor:
    """Zero residuals for the unconditional half of the CFG batch."""
    return torch.cat([torch.zeros_like(x), x])


class ControlNetPipeline(InpaintPipeline):
    """``ControlNetPipeline(config, state, tokenizer)(image, mask,
    control_image, prompt)``.

    ``state`` holds the v1 families and ``controlnet``: one ControlNet
    state dict, or a list of them (Multi-ControlNet, one per branch).
    ``self.controlnet`` is the ``ModuleList`` of branches."""

    def __init__(self, config: PowerPaintConfig, state: Dict[str, dict],
                 tokenizer, dtype: torch.dtype = torch.bfloat16,
                 device=None, int8: Optional[bool] = None,
                 step_callback: Optional[Callable] = None, mesh=None,
                 sequence_parallel: bool = False, sp_min_seq: int = 2048):
        if config.controlnet is None:
            raise ValueError("ControlNetPipeline needs a config with a "
                             "controlnet (ppt_v1_controlnet_config)")
        super().__init__(config, state, tokenizer, dtype=dtype, device=device,
                         int8=int8, step_callback=step_callback, mesh=mesh,
                         sequence_parallel=sequence_parallel,
                         sp_min_seq=sp_min_seq)

    @classmethod
    def from_pipeline(cls, pipe: InpaintPipeline, controlnet,
                      controlnet_config=None) -> "ControlNetPipeline":
        """A ControlNet pipeline over a loaded ppt-v1 pipeline's models
        (shared, not copied; its LoRA and textual-inversion state too) and
        ``controlnet``: one loaded ``ControlNetModel`` or a list of them
        (``io.checkpoint.load_controlnet``), whose config is
        ``controlnet_config`` or the first branch's ``.config``."""
        branches = list(controlnet) if isinstance(
            controlnet, (list, tuple, torch.nn.ModuleList)) else [controlnet]
        cn_cfg = controlnet_config or branches[0].config
        out = cls.__new__(cls)
        # the state, not instance-level overrides of methods (a profiler's
        # wrappers), which stay with the pipeline they wrap
        out.__dict__.update({k: v for k, v in pipe.__dict__.items()
                             if not callable(getattr(type(pipe), k, None))})
        out.config = pipe.config.replace(controlnet=cn_cfg)
        out.controlnet = torch.nn.ModuleList(branches)
        return out

    # ------------------------------------------------------------ branches

    def _residuals(self, i: int, latents: torch.Tensor, t: torch.Tensor,
                   cond: torch.Tensor, control: torch.Tensor,
                   scales: np.ndarray, guess_mode: bool) -> dict:
        """The branches' residuals at iteration i, summed in branch order,
        as the UNet's keyword arguments. ``latents`` the sampler's scaled
        latents; ``control`` (N, B, H, W, 3) in [0, 1]; ``scales``
        (iterations, N)."""
        b = latents.shape[0]
        down_sum, mid_sum = None, None
        row = table_row(scales, i)
        for n, branch in enumerate(self.controlnet):
            scale = float(row[n])
            if guess_mode:
                down, mid = branch(latents, t, cond[b:], control[n], scale,
                                   guess_mode=True)
                down, mid = [_zero_pad(x) for x in down], _zero_pad(mid)
            else:
                down, mid = branch(latents.repeat(2, 1, 1, 1), t, cond,
                                   control[n].repeat(2, 1, 1, 1), scale)
            if down_sum is None:
                down_sum, mid_sum = down, mid
            else:
                down_sum = [a + c for a, c in zip(down_sum, down)]
                mid_sum = mid_sum + mid
        return dict(down_block_additional_residuals=down_sum,
                    mid_block_additional_residual=mid_sum)

    # ------------------------------------------------------------ generate

    @torch.no_grad()
    def _generate(self, ids: torch.Tensor, fittings: torch.Tensor,
                  image_u8: torch.Tensor, mask_u8: torch.Tensor,
                  guidance: torch.Tensor, noise0: torch.Tensor,
                  vae_noise: torch.Tensor, img_noise: torch.Tensor,
                  step_noise, *, control_u8: Optional[torch.Tensor] = None,
                  scales: Optional[np.ndarray] = None,
                  guess_mode: bool = False, **kw) -> torch.Tensor:
        """``InpaintPipeline._generate`` with the branches: control_u8 (N,
        B, H, W, 3) uint8, one control image per branch and image; scales
        (executed steps, N), each branch's conditioning scale per step,
        expanded onto heun's iterations (``per_iteration``). Without
        ``control_u8`` it is the v1 call."""
        if control_u8 is None:
            return super()._generate(ids, fittings, image_u8, mask_u8,
                                     guidance, noise0, vae_noise, img_noise,
                                     step_noise, **kw)
        mod, _ = schedulers.get(kw.get("scheduler", "ddim"))
        rows = len(per_iteration(mod, np.arange(kw["strength_steps"])))
        if scales.shape != (rows, len(self.controlnet)):
            raise ValueError(f"gating table {scales.shape} for {rows} "
                             f"rows and {len(self.controlnet)} branches")
        control = control_u8.float() / 255.0

        def residuals(i, latents, t, cond):
            return self._residuals(i, latents, t, cond, control, scales,
                                   guess_mode)

        return super()._generate(ids, fittings, image_u8, mask_u8, guidance,
                                 noise0, vae_noise, img_noise, step_noise,
                                 residuals=residuals, **kw)

    def _controls(self, control_image, multi: bool,
                  images: np.ndarray) -> np.ndarray:
        """(N, B, H, W, 3) uint8: one control image per branch and image.
        One call: one image or a per-branch list, for every image of the
        call; the batched form: one such entry per request."""
        n, b = len(self.controlnet), images.shape[0]
        per_request = list(control_image) if multi else [control_image] * b
        if len(per_request) != b:
            raise InputValidationError(
                f"{len(per_request)} control entries for {b} requests")
        columns = []
        for c, image in zip(per_request, images):
            branch_images = list(c) if isinstance(c, (list, tuple)) else [c]
            if len(branch_images) != n:
                raise InputValidationError(
                    f"got {len(branch_images)} control images for {n} "
                    "controlnet branches")
            column = [to_numpy_image(x) for x in branch_images]
            for x in column:
                check_control_image(x, image)
            columns.append(column)
        return np.stack([np.stack([col[k] for col in columns])
                         for k in range(n)])

    def __call__(self, image, mask, control_image=None, prompt="",
                 negative_prompt="", task: str = "text-guided",
                 fitting_degree=1.0, num_inference_steps: int = 45,
                 guidance_scale=7.5, controlnet_conditioning_scale=1.0,
                 control_guidance_start=0.0, control_guidance_end=1.0,
                 strength: float = 1.0, eta: float = 0.0,
                 scheduler: str = "ddim", seed=0,
                 num_images_per_prompt: int = 1, guess_mode: bool = False,
                 latents: Optional[np.ndarray] = None,
                 output_type: str = "uint8", clip_skip: int = 0,
                 prompt_embeds: Optional[np.ndarray] = None,
                 negative_prompt_embeds: Optional[np.ndarray] = None,
                 callback: Optional[Callable] = None, callback_steps: int = 1,
                 height: Optional[int] = None, width: Optional[int] = None,
                 cross_attention_kwargs: Optional[dict] = None) -> np.ndarray:
        """Inpaint ``image`` where ``mask`` is 1, conditioned on
        ``control_image`` ((H, W, 3) uint8 edges, depth, ..., or a list of
        them, one per branch). ``controlnet_conditioning_scale``,
        ``control_guidance_start`` and ``control_guidance_end`` are one
        value or one per branch.

        Batched form, as the v1 pipeline's: ``prompt`` a list of B prompts,
        and ``control_image`` a list of B entries, each one image or a
        per-branch list. Returns what the v1 pipeline returns.
        ``prompt_embeds``, ``negative_prompt_embeds``, ``callback``,
        ``callback_steps``, ``height`` and ``width`` as the v1 pipeline
        takes them; ``height`` / ``width`` resize the control images too.
        ``cross_attention_kwargs={"scale": s}``: the loaded LoRA's scale for
        this call alone (``LoraMixin``)."""
        if cross_attention_kwargs:
            call_kw = {k: v for k, v in locals().items()  # not super()'s cell
                       if k not in ("self", "cross_attention_kwargs",
                                    "__class__")}
            return self._with_lora_scale(cross_attention_kwargs,
                                         lambda: self(**call_kw))
        mod = check_scheduler(scheduler, self.config.scheduler,
                              num_inference_steps)
        v1_args = dict(
            prompt=prompt, negative_prompt=negative_prompt, task=task,
            fitting_degree=fitting_degree,
            num_inference_steps=num_inference_steps,
            guidance_scale=guidance_scale, strength=strength, eta=eta,
            seed=seed, num_images_per_prompt=num_images_per_prompt,
            latents=latents, output_type=output_type, clip_skip=clip_skip,
            scheduler=scheduler, prompt_embeds=prompt_embeds,
            negative_prompt_embeds=negative_prompt_embeds, callback=callback,
            callback_steps=callback_steps, height=height, width=width)
        if control_image is None:
            return super().__call__(image, mask, **v1_args)
        multi = isinstance(prompt, (list, tuple))
        if height is not None or width is not None:
            image, mask = apply_target_hw(image, mask, height, width, multi)
            control_image = (
                [_resize_control(c, height, width) for c in control_image]
                if multi else _resize_control(control_image, height, width))

        n = len(self.controlnet)
        scales = _per_branch(controlnet_conditioning_scale, n,
                             "controlnet_conditioning_scale")
        starts = _per_branch(control_guidance_start, n,
                             "control_guidance_start")
        ends = _per_branch(control_guidance_end, n, "control_guidance_end")
        req = self._request(image, mask, prompt, negative_prompt, task,
                            fitting_degree, num_inference_steps,
                            guidance_scale, strength, seed,
                            num_images_per_prompt, output_type, clip_skip,
                            scheduler, control_guidance_start=min(starts),
                            control_guidance_end=max(ends))
        control = self._controls(control_image, multi, req.images)
        table = per_iteration(
            mod, gating_table(req.strength_steps, scales, starts, ends))
        self._set_step_callback(callback, callback_steps, self.step_callback)
        return self._run(req, num_inference_steps, output_type, eta, latents,
                         clip_skip,
                         control_u8=to_device(control, self.device),
                         scales=table, guess_mode=bool(guess_mode),
                         **self._embeds(req, prompt_embeds,
                                        negative_prompt_embeds))


def _resize_control(c, height: int, width: int):
    """One control image, or a per-branch list of them, resized to (height,
    width) as the image is (``tasks.preprocess.resize_to``)."""
    if isinstance(c, (list, tuple)):
        return [resize_to(to_numpy_image(x), None, int(height), int(width))[0]
                for x in c]
    return resize_to(to_numpy_image(c), None, int(height), int(width))[0]


def gating_table(steps: int, scales: List[float], starts: List[float],
                 ends: List[float]) -> np.ndarray:
    """(steps, N) float32: branch n's conditioning scale at executed step
    i, 0 outside its [start, end] window."""
    return np.stack([cond_scale_table(steps, float(sc), s, e)
                     for sc, s, e in zip(scales, starts, ends)], axis=1)
