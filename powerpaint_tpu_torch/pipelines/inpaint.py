"""ppt-v1 pipeline: task-prompted SD inpainting with the 9-channel UNet.

The port of ``powerpaint_tpu/pipelines/inpaint.py`` on PyTorch: one batched
text encode (prompt A / B and the two negatives as four rows of one CLIP
forward), the A/B fitting-degree blend, VAE encode of the masked image, a
DDIM loop with classifier-free guidance folded into the batch (a Python
loop where the JAX package has ``lax.scan``), and VAE decode.

Randomness: each image has its own ``torch.Generator`` seeded with its
seed, from which ``__call__`` draws, in this order, the initial latent
noise, the VAE sample noise of the masked image, the VAE sample noise of
the image latents and, when ``eta > 0``, one DDIM noise tensor per step. A
batched request therefore reproduces each standalone result. The numbers
differ from the JAX package's threefry streams; ``_generate`` takes the
draws as tensors, so a test can hand both packages the same noise.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from powerpaint_tpu_torch.core.config import PowerPaintConfig
from powerpaint_tpu_torch.core.validation import (
    check_call_args,
    check_clip_skip,
    check_image_mask,
    check_output_type,
)
from powerpaint_tpu_torch.io.weights import load_models
from powerpaint_tpu_torch.schedulers import ddim
from powerpaint_tpu_torch.schedulers.common import make_schedule
from powerpaint_tpu_torch.tasks.preprocess import to_numpy_image, to_numpy_mask
from powerpaint_tpu_torch.text.prompts import TaskPrompts, add_task


def _as_list(value, n: int) -> list:
    return list(value) if isinstance(value, (list, tuple)) else [value] * n


class InpaintPipeline:
    """``InpaintPipeline(config, state, tokenizer)(image, mask, prompt)``.

    ``state`` holds one diffusers / transformers named state dict per family
    (``unet``, ``vae``, ``text_encoder``), tensors or numpy arrays. Linear
    and conv weights run in ``dtype``; norm parameters stay fp32. The models
    live on ``device`` (the card unless the caller asks for ``"cpu"``).
    """

    def __init__(self, config: PowerPaintConfig, state: Dict[str, dict],
                 tokenizer, dtype: torch.dtype = torch.bfloat16,
                 device="cuda"):
        self.config = config
        self.tokenizer = tokenizer
        self.dtype = dtype
        self.device = torch.device(device)
        models = load_models(config, state, device=self.device, dtype=dtype)
        self.unet = models["unet"]
        self.vae = models["vae"]
        self.text_encoder = models["text_encoder"]

    # ------------------------------------------------------------ stages

    def encode_task(self, prompts: TaskPrompts) -> np.ndarray:
        return self.tokenizer([prompts.promptA, prompts.promptB,
                               prompts.negative_promptA,
                               prompts.negative_promptB])

    def _encode_prompts(self, ids: torch.Tensor, fittings: torch.Tensor,
                        b: int, clip_skip: int) -> torch.Tensor:
        """ids (P, 4, 77) -> CFG context (2B, 77, D), [negatives; positives],
        each the A/B blend ``A * t + (1 - t) * B`` by the fitting degree."""
        p, _, s = ids.shape
        emb = self.text_encoder(ids.reshape(p * 4, s), clip_skip=clip_skip)
        emb = emb.reshape(p, 4, s, -1)
        t = fittings.reshape(-1, 1, 1)
        pos = emb[:, 0] * t + (1.0 - t) * emb[:, 1]
        neg = emb[:, 2] * t + (1.0 - t) * emb[:, 3]
        if p != b:  # one prompt, several images
            pos = pos.repeat_interleave(b // p, dim=0)
            neg = neg.repeat_interleave(b // p, dim=0)
        return torch.cat([neg, pos], dim=0)

    def _vae_sample(self, images: torch.Tensor,
                    noise: torch.Tensor) -> torch.Tensor:
        """Encode and draw one scaled latent sample per image."""
        mean, logvar = self.vae.encode(images)
        std = torch.exp(0.5 * logvar.float())
        return (mean.float() + std * noise) * self.config.vae.scaling_factor

    def _denoise(self, sched, latents: torch.Tensor, mask_lat: torch.Tensor,
                 masked_lat: torch.Tensor, cond: torch.Tensor,
                 guidance: torch.Tensor, eta: float,
                 step_noise: Optional[Sequence[torch.Tensor]]) -> torch.Tensor:
        """DDIM loop; the UNet sees [latents, mask, masked-image latents]
        for the unconditional and the conditional half in one batch."""
        b = latents.shape[0]
        extra = torch.cat([mask_lat, masked_lat], dim=-1).repeat(2, 1, 1, 1)
        for i in range(sched.num_steps):
            lmi = torch.cat([latents.repeat(2, 1, 1, 1), extra], dim=-1)
            t = torch.tensor(int(sched.timesteps[i]), device=latents.device)
            eps = self.unet(lmi, t, cond).float()
            eps = eps[:b] + guidance * (eps[b:] - eps[:b])
            noise = step_noise[i] if eta > 0.0 else None
            latents = ddim.step(sched, eps, i, latents, eta=eta, noise=noise)
        return latents

    def _decode(self, latents: torch.Tensor) -> torch.Tensor:
        z = (latents / self.config.vae.scaling_factor).to(self.dtype)
        return self.vae.decode(z)

    # ------------------------------------------------------------ generate

    @torch.no_grad()
    def _generate(self, ids: torch.Tensor, fittings: torch.Tensor,
                  image_u8: torch.Tensor, mask_u8: torch.Tensor,
                  guidance: torch.Tensor, noise0: torch.Tensor,
                  vae_noise: torch.Tensor, img_noise: torch.Tensor,
                  step_noise: Optional[Sequence[torch.Tensor]], *,
                  num_steps: int, strength_steps: int, output_type: str,
                  eta: float = 0.0, latents_in: Optional[torch.Tensor] = None,
                  clip_skip: int = 0) -> torch.Tensor:
        """Everything after host-side validation, on ``self.device``.

        ids (P, 4, 77); fittings (P,); image_u8 (B, H, W, 3) uint8; mask_u8
        (B, H, W, 1) uint8 in {0, 255}; guidance (B,); noise0, vae_noise,
        img_noise (B, H/8, W/8, 4) fp32; step_noise one (B, H/8, W/8, 4)
        tensor per kept step when ``eta > 0``."""
        sched = make_schedule(
            self.config.scheduler, num_steps,
            keep_steps=strength_steps if strength_steps < num_steps else None)
        b, h, w, _ = image_u8.shape
        init_image = image_u8.float() / 127.5 - 1.0
        mask = (mask_u8 >= 128).float()
        masked_image = init_image * (1.0 - mask)

        cond = self._encode_prompts(ids, fittings, b, clip_skip)
        masked_lat = self._vae_sample(masked_image, vae_noise)
        # half-pixel-centre nearest, as jax.image.resize(..., "nearest")
        mask_lat = F.interpolate(mask.permute(0, 3, 1, 2), size=(h // 8, w // 8),
                                 mode="nearest-exact").permute(0, 2, 3, 1)
        image_latents = None
        if strength_steps < num_steps:
            image_latents = self._vae_sample(init_image, img_noise)
        if latents_in is not None:
            latents = latents_in.float() * sched.init_noise_sigma
        elif image_latents is not None:
            latents = ddim.add_noise_at(sched, image_latents, noise0, 0)
        else:
            latents = noise0 * sched.init_noise_sigma

        latents = self._denoise(sched, latents, mask_lat, masked_lat, cond,
                                guidance.float().reshape(-1, 1, 1, 1), eta,
                                step_noise)
        if output_type == "latent":
            return latents
        image = self._decode(latents)
        if output_type == "uint8":
            img01 = torch.clamp(image.float() / 2 + 0.5, 0.0, 1.0)
            return torch.round(img01 * 255.0).to(torch.uint8)
        return image.float()

    def _draw_noise(self, seeds: Sequence[int], shape, n_steps: int,
                    eta: float) -> List:
        """Per-image draws: [noise0, vae_noise, img_noise, step_noise]."""
        per_image = []
        for seed in seeds:
            g = torch.Generator(device=self.device).manual_seed(int(seed))
            draws = [torch.randn(shape, generator=g, device=self.device)
                     for _ in range(3 + (n_steps if eta > 0.0 else 0))]
            per_image.append(draws)
        stacked = [torch.stack(d) for d in zip(*per_image)]
        return stacked[:3] + [stacked[3:] if eta > 0.0 else None]

    def __call__(self, image, mask, prompt="", negative_prompt="",
                 task: str = "text-guided", fitting_degree=1.0,
                 num_inference_steps: int = 45, guidance_scale=7.5,
                 strength: float = 1.0, eta: float = 0.0, seed=0,
                 num_images_per_prompt: int = 1,
                 latents: Optional[np.ndarray] = None,
                 output_type: str = "uint8", clip_skip: int = 0) -> np.ndarray:
        """Inpaint ``image`` (H, W, 3) where ``mask`` (H, W) is 1.

        Batched form: ``prompt`` a list of B prompts, with ``image`` /
        ``mask`` either one pair for all or B stacked pairs, and
        ``negative_prompt`` / ``fitting_degree`` / ``guidance_scale`` /
        ``seed`` one value or one per request. Returns (B, H, W, 3) uint8,
        (B, H, W, 3) float32 in [-1, 1] or (B, H/8, W/8, 4) float32 latents,
        as numpy."""
        multi = isinstance(prompt, (list, tuple))
        prompts = list(prompt) if multi else [prompt]
        negatives = _as_list(negative_prompt, len(prompts))
        fittings = _as_list(fitting_degree, len(prompts))
        guidances = _as_list(guidance_scale, len(prompts))

        if multi and np.asarray(image).ndim == 4:
            img_b = np.stack([to_numpy_image(im) for im in image])
            masks = [to_numpy_mask(m) for m in mask]
            for im, m in zip(img_b, masks):
                check_image_mask(im, m)
            mask_b = np.stack([(m >= 0.5).astype(np.uint8)[..., None] * 255
                               for m in masks])
        else:
            img = to_numpy_image(image)
            msk = to_numpy_mask(mask)
            check_image_mask(img, msk)
            n = len(prompts) if multi else num_images_per_prompt
            img_b = np.tile(img[None], (n, 1, 1, 1))
            mask_b = np.tile((msk >= 0.5).astype(np.uint8)[None, ..., None] * 255,
                             (n, 1, 1, 1))
        b, h, w, _ = img_b.shape
        for f, g in zip(fittings, guidances):
            check_call_args(task=task, num_inference_steps=num_inference_steps,
                            guidance_scale=float(g), strength=strength,
                            fitting_degree=float(f))
        check_output_type(output_type)
        check_clip_skip(clip_skip, self.config.text_encoder.num_hidden_layers)
        if len(guidances) != b:
            guidances = [guidances[0]] * b

        if isinstance(seed, (list, tuple)):
            seeds = [int(s) for s in seed]
        else:  # one request, N images: seeds follow the base seed
            seeds = [int(seed) + i for i in range(b)]
        if len(seeds) != b:
            raise ValueError(f"{len(seeds)} seeds for {b} images")

        ids = np.stack([self.encode_task(add_task(p, n, task, "ppt-v1"))
                        for p, n in zip(prompts, negatives)])
        strength_steps = min(int(num_inference_steps * strength),
                             num_inference_steps)
        noise0, vae_noise, img_noise, step_noise = self._draw_noise(
            seeds, (h // 8, w // 8, 4), strength_steps, float(eta))

        dev = self.device
        out = self._generate(
            torch.as_tensor(ids, dtype=torch.long, device=dev),
            torch.as_tensor(np.asarray(fittings, np.float32), device=dev),
            torch.as_tensor(img_b, device=dev),
            torch.as_tensor(mask_b, device=dev),
            torch.as_tensor(np.asarray(guidances, np.float32), device=dev),
            noise0, vae_noise, img_noise, step_noise,
            num_steps=num_inference_steps, strength_steps=strength_steps,
            output_type=output_type, eta=float(eta),
            latents_in=(None if latents is None
                        else torch.as_tensor(latents, device=dev)),
            clip_skip=int(clip_skip))
        return out.cpu().numpy()
