"""ppt-v2 pipeline: BrushNet dual-branch inpainting with preserved
cross-attention, sampled with UniPC.

The port of ``powerpaint_tpu/pipelines/brushnet.py`` on PyTorch:

- two text towers: the BrushNet branch sees the task-token embeddings
  (``text_encoder_brushnet``: prompts A, B and the two negatives, blended
  by the fitting degree), the frozen base UNet the plain prompt pair
  (``text_encoder``: promptU and its negative);
- 5-channel conditioning: the VAE sample of the pre-masked image (hole
  pixels black) times the scaling factor, then the keep mask (1 on
  preserved pixels) resized nearest to the latent grid;
- per step, one BrushNet forward (CFG batch 2B, task embeddings) giving 28
  taps, one base-UNet forward (2B, plain embeddings) with the taps
  injected, the guidance combine and a UniPC step (a Python loop where the
  JAX package has ``lax.scan``);
- ``control_guidance_start`` / ``_end`` gate the branch per step through a
  host table of conditioning scales.

Randomness: each image has its own ``torch.Generator`` seeded with its
seed, from which ``__call__`` draws, in this order, the initial latent
noise and the VAE sample noise of the masked image, so a batched request
reproduces each standalone result. ``_generate`` takes both draws as
tensors, so a test can hand in the JAX package's threefry streams.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from powerpaint_tpu_torch.core.config import PowerPaintConfig
from powerpaint_tpu_torch.core.metrics import GLOBAL as telemetry
from powerpaint_tpu_torch.core.validation import (
    check_call_args,
    check_clip_skip,
    check_output_type,
    check_scheduler,
)
from powerpaint_tpu_torch.io.weights import load_models
from powerpaint_tpu_torch.pipelines.common import (
    as_list,
    batch_inputs,
    draw_noise,
    int8_x_scale,
    resolve_seeds,
    to_output,
    vae_sample,
)
from powerpaint_tpu_torch.schedulers import unipc
from powerpaint_tpu_torch.text.prompts import TaskPrompts, add_task, v2_prompt_suffix


def cond_scale_table(num_steps: int, scale: float, start: float,
                     end: float) -> np.ndarray:
    """The branch's conditioning scale per step: ``scale`` inside the
    [start, end] window of the schedule, 0 outside."""
    keeps = np.array([1.0 - float(i / num_steps < start
                                  or (i + 1) / num_steps > end)
                      for i in range(num_steps)], np.float32)
    return keeps * scale


class BrushNetPipeline:
    """``BrushNetPipeline(config, state, tokenizer)(image, mask, prompt)``.

    ``state`` holds one diffusers / transformers named state dict per family
    (``unet``, ``vae``, ``brushnet``, ``text_encoder`` (plain) and
    ``text_encoder_brushnet`` (task tokens)), tensors or numpy arrays.
    Linear and conv weights run in ``dtype``; norm parameters stay fp32. The
    models live on ``device`` (the card unless the caller asks for
    ``"cpu"``).
    ``int8=True`` runs the ResNet units the JAX package quantises as the
    static-scale int8 W8A8 kernel (``pipelines.common.int8_x_scale``;
    ``None`` reads ``POWERPAINT_INT8`` here, once).
    """

    def __init__(self, config: PowerPaintConfig, state: Dict[str, dict],
                 tokenizer, dtype: torch.dtype = torch.bfloat16,
                 device="cuda", int8: Optional[bool] = None):
        if config.brushnet is None:
            raise ValueError("BrushNetPipeline needs a config with a brushnet "
                             "(ppt_v2_config)")
        self.config = config
        self.tokenizer = tokenizer
        self.dtype = dtype
        self.device = torch.device(device)
        self.int8_x_scale = int8_x_scale(int8)
        models = load_models(config, state, device=self.device, dtype=dtype,
                             int8_x_scale=self.int8_x_scale)
        self.unet = models["unet"]
        self.vae = models["vae"]
        self.brushnet = models["brushnet"]
        self.text_encoder = models["text_encoder"]
        self.text_encoder_brushnet = models["text_encoder_brushnet"]

    # ------------------------------------------------------------ stages

    def encode_task(self, prompts: TaskPrompts) -> Tuple[np.ndarray, np.ndarray]:
        """Token ids: (4, 77) [A, B, negA, negB] and (2, 77) [U, negU]."""
        return (self.tokenizer([prompts.promptA, prompts.promptB,
                                prompts.negative_promptA,
                                prompts.negative_promptB]),
                self.tokenizer([prompts.promptU, prompts.negative_promptU]))

    def _encode_prompts(self, ids_task: torch.Tensor, ids_plain: torch.Tensor,
                        fittings: torch.Tensor, b: int,
                        clip_skip: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """ids_task (P, 4, 77), ids_plain (P, 2, 77) -> the CFG contexts
        (2B, 77, D) [negatives; positives] of the branch (task embeddings,
        each pair blended ``A * t + (1 - t) * B``) and of the base UNet
        (plain embeddings; ``clip_skip`` applies to this tower)."""
        p, _, s = ids_task.shape
        emb = self.text_encoder_brushnet(ids_task.reshape(p * 4, s))
        emb = emb.reshape(p, 4, s, -1)
        t = fittings.reshape(-1, 1, 1)
        pos_t = emb[:, 0] * t + (1.0 - t) * emb[:, 1]
        neg_t = emb[:, 2] * t + (1.0 - t) * emb[:, 3]
        plain = self.text_encoder(ids_plain.reshape(p * 2, s),
                                  clip_skip=clip_skip).reshape(p, 2, s, -1)
        pos_u, neg_u = plain[:, 0], plain[:, 1]
        if p != b:  # one prompt, several images
            pos_t, neg_t, pos_u, neg_u = (e.repeat_interleave(b // p, dim=0)
                                          for e in (pos_t, neg_t, pos_u, neg_u))
        return torch.cat([neg_t, pos_t]), torch.cat([neg_u, pos_u])

    def _vae_sample(self, images: torch.Tensor,
                    noise: torch.Tensor) -> torch.Tensor:
        return vae_sample(self.vae, images, noise,
                          self.config.vae.scaling_factor)

    def _branch(self, sched, i: int, latents: torch.Tensor,
                cond_task: torch.Tensor, cond5: torch.Tensor, scale: float,
                guess_mode: bool):
        """The BrushNet taps at step i for the CFG batch. In guess mode the
        branch sees only the conditional half; the other half's taps are
        zero."""
        t = torch.tensor(int(sched.timesteps[i]), device=latents.device)
        b = latents.shape[0]
        if not guess_mode:
            lmi = unipc.scale_model_input(sched, latents.repeat(2, 1, 1, 1), i)
            return self.brushnet(lmi, t, cond_task, cond5, scale)
        down, mid, up = self.brushnet(
            unipc.scale_model_input(sched, latents, i), t, cond_task[b:],
            cond5[:b], scale, guess_mode=True)
        pad = lambda x: torch.cat([torch.zeros_like(x), x])  # noqa: E731
        return [pad(x) for x in down], pad(mid), [pad(x) for x in up]

    def _denoise(self, sched, latents: torch.Tensor, cond5: torch.Tensor,
                 cond_task: torch.Tensor, cond_plain: torch.Tensor,
                 guidance: torch.Tensor, scales: np.ndarray,
                 guess_mode: bool) -> torch.Tensor:
        """UniPC loop: the branch's taps, then the base UNet on the latents
        for the unconditional and the conditional half in one batch."""
        b = latents.shape[0]
        state = unipc.init_state(sched, latents.shape, latents.device)
        for i in range(sched.num_steps):
            down, mid, up = self._branch(sched, i, latents, cond_task, cond5,
                                         float(scales[i]), guess_mode)
            lmi = unipc.scale_model_input(sched, latents.repeat(2, 1, 1, 1), i)
            t = torch.tensor(int(sched.timesteps[i]), device=latents.device)
            eps = self.unet(lmi, t, cond_plain, down_block_add_samples=down,
                            mid_block_add_sample=mid,
                            up_block_add_samples=up).float()
            eps = eps[:b] + guidance * (eps[b:] - eps[:b])
            latents, state = unipc.step(sched, state, eps, i, latents)
        return latents

    def _decode(self, latents: torch.Tensor) -> torch.Tensor:
        z = (latents / self.config.vae.scaling_factor).to(self.dtype)
        return self.vae.decode(z)

    # ------------------------------------------------------------ generate

    @torch.no_grad()
    def _generate(self, ids_task: torch.Tensor, ids_plain: torch.Tensor,
                  fittings: torch.Tensor, image_u8: torch.Tensor,
                  mask_u8: torch.Tensor, guidance: torch.Tensor,
                  scales: np.ndarray, noise0: torch.Tensor,
                  vae_noise: torch.Tensor, *, num_steps: int,
                  output_type: str, guess_mode: bool = False,
                  latents_in: Optional[torch.Tensor] = None,
                  clip_skip: int = 0) -> torch.Tensor:
        """Everything after host-side validation, on ``self.device``.

        ids_task (P, 4, 77); ids_plain (P, 2, 77); fittings (P,); image_u8
        (B, H, W, 3) uint8; mask_u8 (B, H, W, 1) uint8, 255 in the hole;
        guidance (B,); scales (num_steps,) the branch's scale per step;
        noise0 and vae_noise (B, H/8, W/8, 4) fp32."""
        sched = unipc.make_unipc_schedule(self.config.scheduler, num_steps)
        b, h, w, _ = image_u8.shape
        keep = 1.0 - (mask_u8 >= 128).float()
        masked_image = image_u8.float() * keep / 127.5 - 1.0

        cond_task, cond_plain = self._encode_prompts(ids_task, ids_plain,
                                                     fittings, b, clip_skip)
        cond_lat = self._vae_sample(masked_image, vae_noise)
        # half-pixel-centre nearest, as jax.image.resize(..., "nearest")
        keep8 = F.interpolate(keep.permute(0, 3, 1, 2), size=(h // 8, w // 8),
                              mode="nearest-exact").permute(0, 2, 3, 1)
        cond5 = torch.cat([cond_lat, keep8], dim=-1).repeat(2, 1, 1, 1)
        if latents_in is not None:
            latents = latents_in.float() * sched.init_noise_sigma
        else:
            latents = noise0 * sched.init_noise_sigma

        latents = self._denoise(sched, latents, cond5, cond_task, cond_plain,
                                guidance.float().reshape(-1, 1, 1, 1), scales,
                                guess_mode)
        if output_type == "latent":
            return latents
        return to_output(self._decode(latents), output_type)

    def __call__(self, image, mask, prompt="", negative_prompt="",
                 task: str = "text-guided", fitting_degree=1.0,
                 num_inference_steps: int = 45, guidance_scale=7.5,
                 brushnet_conditioning_scale: float = 1.0,
                 control_guidance_start: float = 0.0,
                 control_guidance_end: float = 1.0, seed=0,
                 num_images_per_prompt: int = 1, guess_mode: bool = False,
                 latents: Optional[np.ndarray] = None,
                 output_type: str = "uint8", clip_skip: int = 0,
                 scheduler: str = "unipc") -> np.ndarray:
        """Inpaint ``image`` (H, W, 3) where ``mask`` (H, W) is 1.

        Batched form: ``prompt`` a list of B prompts, with ``image`` /
        ``mask`` either one pair for all or B stacked pairs, and
        ``negative_prompt`` / ``fitting_degree`` / ``guidance_scale`` /
        ``seed`` one value or one per request. Returns (B, H, W, 3) uint8,
        (B, H, W, 3) float32 in [-1, 1] or (B, H/8, W/8, 4) float32 latents,
        as numpy."""
        multi = isinstance(prompt, (list, tuple))
        prompts = list(prompt) if multi else [prompt]
        negatives = as_list(negative_prompt, len(prompts))
        fittings = as_list(fitting_degree, len(prompts))
        guidances = as_list(guidance_scale, len(prompts))
        check_scheduler(scheduler, num_inference_steps)
        for f, g in zip(fittings, guidances):
            check_call_args(task=task, num_inference_steps=num_inference_steps,
                            guidance_scale=float(g), fitting_degree=float(f),
                            control_guidance_start=control_guidance_start,
                            control_guidance_end=control_guidance_end)
        check_output_type(output_type)
        check_clip_skip(clip_skip, self.config.text_encoder.num_hidden_layers)
        img_b, mask_b = batch_inputs(
            image, mask, multi, len(prompts) if multi else num_images_per_prompt)
        b, h, w, _ = img_b.shape
        if len(guidances) != b:
            guidances = [guidances[0]] * b
        seeds = resolve_seeds(seed, b)

        ids = [self.encode_task(add_task(v2_prompt_suffix(p, task), n, task,
                                         "ppt-v2"))
               for p, n in zip(prompts, negatives)]
        ids_task = np.stack([t for t, _ in ids])
        ids_plain = np.stack([u for _, u in ids])
        scales = cond_scale_table(num_inference_steps,
                                  float(brushnet_conditioning_scale),
                                  control_guidance_start, control_guidance_end)
        noise0, vae_noise = draw_noise(self.device, seeds, (h // 8, w // 8, 4), 2)

        dev = self.device
        telemetry.reset_stages()
        with telemetry.stage("generate"):
            out = self._generate(
                torch.as_tensor(ids_task, dtype=torch.long, device=dev),
                torch.as_tensor(ids_plain, dtype=torch.long, device=dev),
                torch.as_tensor(np.asarray(fittings, np.float32), device=dev),
                torch.as_tensor(img_b, device=dev),
                torch.as_tensor(mask_b, device=dev),
                torch.as_tensor(np.asarray(guidances, np.float32), device=dev),
                scales, noise0, vae_noise,
                num_steps=num_inference_steps, output_type=output_type,
                guess_mode=bool(guess_mode),
                latents_in=(None if latents is None
                            else torch.as_tensor(latents, device=dev)),
                clip_skip=int(clip_skip)).cpu().numpy()
        telemetry.count("images", out.shape[0])
        telemetry.count("denoise_steps", num_inference_steps)
        return out
