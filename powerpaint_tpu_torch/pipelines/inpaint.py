"""ppt-v1 pipeline: task-prompted SD inpainting with the 9-channel UNet.

The port of ``powerpaint_tpu/pipelines/inpaint.py`` on PyTorch: one batched
text encode (prompt A / B and the two negatives as four rows of one CLIP
forward), the A/B fitting-degree blend, VAE encode of the masked image, a
denoise loop with classifier-free guidance folded into the batch (a
Python loop where the JAX package has ``lax.scan``) over any registry
sampler (``scheduler=``, DDIM by default), and VAE decode (with the
request's image and hole mask on an asymmetric VAE).

``encoder_cache_interval`` n > 1 turns on encoder propagation: every n-th
iteration is a key step that runs the whole UNet and keeps its encoder's
features, the others run only its mid and up blocks on them
(``models.unet``).

The call surface of the reference's pipeline: ``prompt_embeds`` /
``negative_prompt_embeds`` replace the blended pair (when both are given
the text encoder does not run), ``callback`` / ``callback_steps``
observe the loop (``pipelines.common.StepCallbackMixin``), and ``height``
/ ``width`` resize the inputs first (``pipelines.common.apply_target_hw``).

Randomness: per-image ``torch.Generator`` draws in the order
``pipelines.common`` documents (the initial latent noise, the two VAE
sample noises, then the step noise of a stochastic sampler or of DDIM
with ``eta > 0``), so a batched request reproduces each standalone
result. ``_generate`` takes the draws as tensors, so a test can hand both
packages the same noise.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

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
from powerpaint_tpu_torch.io.aot import AotPipelineMixin
from powerpaint_tpu_torch.io.lora import LoraMixin
from powerpaint_tpu_torch.io.weights import load_models
from powerpaint_tpu_torch.pipelines.async_dispatch import AsyncDispatchMixin, finish
from powerpaint_tpu_torch.pipelines.common import (
    MeshMixin,
    StepCallbackMixin,
    apply_target_hw,
    as_list,
    batch_inputs,
    draw_noise,
    embeds_rows,
    int8_x_scale,
    make_sampler,
    norm_embeds,
    pipeline_device,
    resolve_seeds,
    rows,
    sampler_step,
    step_timesteps,
    takes_step_noise,
    to_device,
    to_output,
    vae_sample,
)
from powerpaint_tpu_torch.text.prompts import TaskPrompts, add_task


class Request(NamedTuple):
    """One call's inputs after host-side validation and batching."""

    images: np.ndarray  # (B, H, W, 3) uint8
    masks: np.ndarray  # (B, H, W, 1) uint8, 255 in the hole
    ids: np.ndarray  # (P, 4, 77) [A, B, negA, negB] per prompt
    fittings: list  # P fitting degrees
    guidances: list  # B guidance scales
    seeds: list  # B seeds
    strength_steps: int  # the steps executed
    scheduler: str  # the registry sampler


class InpaintPipeline(AotPipelineMixin, AsyncDispatchMixin, LoraMixin,
                      MeshMixin, StepCallbackMixin):
    """``InpaintPipeline(config, state, tokenizer)(image, mask, prompt)``.

    ``state`` holds one diffusers / transformers named state dict per family
    (``unet``, ``vae``, ``text_encoder``), tensors or numpy arrays. Linear
    and conv weights run in ``dtype``; norm parameters stay fp32. The models
    live on ``device`` (the card unless the caller asks for ``"cpu"``).
    ``int8=True`` runs the ResNet units the JAX package quantises as the
    static-scale int8 W8A8 kernel (``pipelines.common.int8_x_scale``;
    ``None`` reads ``POWERPAINT_INT8`` here, once). ``step_callback`` is the
    callback of every call that passes none (``StepCallbackMixin``).
    ``mesh``: a ``parallel.mesh.Mesh`` to run over, every rank making the
    same calls (``MeshMixin``); ``sequence_parallel=True`` there splits
    each image's rows over the data group instead of the batch, with
    self-attention of at least ``sp_min_seq`` canvas tokens on the ring
    (``MeshMixin``).
    """

    def __init__(self, config: PowerPaintConfig, state: Dict[str, dict],
                 tokenizer, dtype: torch.dtype = torch.bfloat16,
                 device=None, int8: Optional[bool] = None,
                 step_callback: Optional[Callable] = None, mesh=None,
                 sequence_parallel: bool = False, sp_min_seq: int = 2048):
        self.config = config
        self.sequence_parallel = bool(sequence_parallel)
        self.sp_min_seq = int(sp_min_seq)
        self.step_callback = step_callback
        self.tokenizer = tokenizer
        self.dtype = dtype
        self.mesh = mesh
        self.device = pipeline_device(device, mesh)
        self.int8_x_scale = int8_x_scale(int8)
        models = load_models(config, state, device=self.device, dtype=dtype,
                             int8_x_scale=self.int8_x_scale,
                             tp=None if mesh is None else mesh.tp)
        self.unet = models["unet"]
        self.vae = models["vae"]
        self.text_encoder = models["text_encoder"]
        self.controlnet = models.get("controlnet")  # ControlNetPipeline's

    # ------------------------------------------------------------ stages

    def encode_task(self, prompts: TaskPrompts) -> np.ndarray:
        return self.tokenizer([prompts.promptA, prompts.promptB,
                               prompts.negative_promptA,
                               prompts.negative_promptB])

    def _encode_prompts(self, ids: torch.Tensor, fittings: torch.Tensor,
                        b: int, clip_skip: int,
                        pos_in: Optional[torch.Tensor] = None,
                        neg_in: Optional[torch.Tensor] = None) -> torch.Tensor:
        """ids (P, 4, 77) -> CFG context (2B, 77, D), [negatives; positives],
        each the A/B blend ``A * t + (1 - t) * B`` by the fitting degree
        (float32: the fp32 fitting degrees promote it). ``pos_in`` /
        ``neg_in`` (B, 77, D) float32 replace their half; with both the
        text encoder does not run."""
        if pos_in is not None and neg_in is not None:
            return torch.cat([neg_in, pos_in], dim=0)
        p, _, s = ids.shape
        emb = self.text_encoder(ids.reshape(p * 4, s), clip_skip=clip_skip)
        emb = emb.reshape(p, 4, s, -1)
        t = fittings.reshape(-1, 1, 1)
        pos = emb[:, 0] * t + (1.0 - t) * emb[:, 1]
        neg = emb[:, 2] * t + (1.0 - t) * emb[:, 3]
        if p != b:  # one prompt, several images
            pos = pos.repeat_interleave(b // p, dim=0)
            neg = neg.repeat_interleave(b // p, dim=0)
        pos = pos if pos_in is None else pos_in.to(pos.dtype)
        neg = neg if neg_in is None else neg_in.to(neg.dtype)
        return torch.cat([neg, pos], dim=0)

    def _vae_sample(self, images: torch.Tensor,
                    noise: torch.Tensor) -> torch.Tensor:
        return vae_sample(self.vae, images, noise,
                          self.config.vae.scaling_factor)

    def _denoise(self, mod, sched, latents: torch.Tensor,
                 mask_lat: torch.Tensor, masked_lat: torch.Tensor,
                 cond: torch.Tensor, guidance: torch.Tensor, eta: float,
                 step_noise: Optional[Sequence[torch.Tensor]],
                 residuals: Optional[Callable] = None,
                 encoder_cache_interval: int = 1) -> torch.Tensor:
        """The sampler ``mod``'s loop, one UNet evaluation an iteration; the
        UNet sees [the sampler's scaled latents, mask, masked-image latents]
        for the unconditional and the conditional half in one batch.
        ``residuals(i, scaled_latents, t, cond)``, when given, returns the
        keyword arguments (the ControlNet residuals) of iteration i's UNet
        call. With ``encoder_cache_interval`` n > 1, iteration i is a key
        step when i % n == 0; the others reuse its encoder features."""
        b = latents.shape[0]
        extra = torch.cat([mask_lat, masked_lat], dim=-1).repeat(2, 1, 1, 1)
        state = mod.init_state(sched, latents.shape, latents.device)
        timesteps = step_timesteps(sched, latents.device)
        cache = None
        for i in range(sched.num_steps):
            scaled = mod.scale_model_input(sched, latents, i)
            lmi = torch.cat([scaled.repeat(2, 1, 1, 1), extra], dim=-1)
            t = timesteps[i]
            kw = residuals(i, scaled, t, cond) if residuals is not None else {}
            if encoder_cache_interval <= 1:
                eps = self.unet(lmi, t, cond, **kw)
            elif i % encoder_cache_interval == 0:
                eps, cache = self.unet(lmi, t, cond, emit_encoder_cache=True, **kw)
            else:
                eps = self.unet(lmi, t, cond, encoder_cache=cache, **kw)
            eps = eps.float()
            eps = eps[:b] + guidance * (eps[b:] - eps[:b])
            self._run_step_callback(i, latents)
            latents, state = sampler_step(mod, sched, state, eps, i, latents,
                                          eta, step_noise)
        return latents

    def _decode(self, latents: torch.Tensor, image: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Latents -> image; an asymmetric VAE decodes with ``image`` (B, H,
        W, 3) in [-1, 1] and the hole ``mask`` (B, H, W, 1)."""
        z = (latents / self.config.vae.scaling_factor).to(self.dtype)
        if image is None:
            return self.vae.decode(z)
        return self.vae.decode_with_condition(z, image, mask)

    # ------------------------------------------------------------ generate

    @torch.no_grad()
    def _generate(self, ids: torch.Tensor, fittings: torch.Tensor,
                  image_u8: torch.Tensor, mask_u8: torch.Tensor,
                  guidance: torch.Tensor, noise0: torch.Tensor,
                  vae_noise: torch.Tensor, img_noise: torch.Tensor,
                  step_noise: Optional[Sequence[torch.Tensor]], *,
                  num_steps: int, strength_steps: int, output_type: str,
                  eta: float = 0.0, latents_in: Optional[torch.Tensor] = None,
                  clip_skip: int = 0, scheduler: str = "ddim",
                  residuals: Optional[Callable] = None,
                  prompt_embeds: Optional[torch.Tensor] = None,
                  negative_prompt_embeds: Optional[torch.Tensor] = None,
                  encoder_cache_interval: int = 1) -> torch.Tensor:
        """Everything after host-side validation, on ``self.device``.

        ids (P, 4, 77); fittings (P,); image_u8 (B, H, W, 3) uint8; mask_u8
        (B, H, W, 1) uint8 in {0, 255}; guidance (B,); noise0, vae_noise,
        img_noise (B, H/8, W/8, 4) fp32; step_noise one (B, H/8, W/8, 4)
        tensor per sampler iteration when the sampler takes it
        (``pipelines.common.takes_step_noise``), else None; ``residuals``
        as ``_denoise`` takes it; ``prompt_embeds`` /
        ``negative_prompt_embeds`` (B, 77, D) float32 or None, as
        ``_encode_prompts`` takes them. An asymmetric VAE decodes with the
        image and the hole mask, except where the ControlNet branches ran
        (``residuals``): that path decodes plainly, as the JAX package's
        ``ControlNetPipeline`` does."""
        mod, sched = make_sampler(scheduler, self.config.scheduler, num_steps,
                                  strength_steps)
        b, h, w, _ = image_u8.shape
        init_image = image_u8.float() / 127.5 - 1.0
        mask = (mask_u8 >= 128).float()
        masked_image = init_image * (1.0 - mask)

        cond = self._encode_prompts(ids, fittings, b, clip_skip,
                                    prompt_embeds, negative_prompt_embeds)
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
            latents = mod.add_noise_at(sched, image_latents, noise0, 0)
        else:
            latents = noise0 * sched.init_noise_sigma

        latents = self._denoise(mod, sched, latents, mask_lat, masked_lat, cond,
                                guidance.float().reshape(-1, 1, 1, 1), eta,
                                step_noise, residuals, encoder_cache_interval)
        if output_type == "latent":
            return latents
        if self.config.vae.asymmetric and residuals is None:
            return to_output(self._decode(latents, init_image, mask), output_type)
        return to_output(self._decode(latents), output_type)

    def _draw_noise(self, seeds: Sequence[int], shape,
                    n_step_draws: int) -> List:
        """Per-image draws: [noise0, vae_noise, img_noise, step_noise]
        (``n_step_draws`` step draws, None for none)."""
        stacked = draw_noise(self.device, seeds, shape, 3 + n_step_draws)
        return stacked[:3] + [stacked[3:] if n_step_draws else None]

    def __call__(self, image, mask, prompt="", negative_prompt="",
                 task: str = "text-guided", fitting_degree=1.0,
                 num_inference_steps: int = 45, guidance_scale=7.5,
                 strength: float = 1.0, eta: float = 0.0, seed=0,
                 num_images_per_prompt: int = 1,
                 latents: Optional[np.ndarray] = None,
                 output_type: str = "uint8", encoder_cache_interval: int = 1,
                 clip_skip: int = 0, scheduler: str = "ddim",
                 prompt_embeds: Optional[np.ndarray] = None,
                 negative_prompt_embeds: Optional[np.ndarray] = None,
                 callback: Optional[Callable] = None, callback_steps: int = 1,
                 height: Optional[int] = None, width: Optional[int] = None,
                 cross_attention_kwargs: Optional[dict] = None) -> np.ndarray:
        """Inpaint ``image`` (H, W, 3) where ``mask`` (H, W) is 1, sampled
        with the registry sampler ``scheduler`` (``eta`` is DDIM's).

        Batched form: ``prompt`` a list of B prompts, with ``image`` /
        ``mask`` either one pair for all or B stacked pairs, and
        ``negative_prompt`` / ``fitting_degree`` / ``guidance_scale`` /
        ``seed`` one value or one per request. Returns (B, H, W, 3) uint8,
        (B, H, W, 3) float32 in [-1, 1] or (B, H/8, W/8, 4) float32 latents,
        as numpy. ``cross_attention_kwargs={"scale": s}``: the loaded
        LoRA's scale for this call alone (``LoraMixin``).

        ``prompt_embeds`` / ``negative_prompt_embeds``: (B|1, 77, D) or (77,
        D) arrays in place of the blended positive / negative embeddings;
        ``callback(i, latents)`` every ``callback_steps`` iterations
        (``StepCallbackMixin``); ``height`` and ``width`` (together)
        resize the image and mask to that size first.
        ``encoder_cache_interval`` n > 1: encoder propagation, a whole UNet
        evaluation every n-th iteration and the mid and up blocks on its
        encoder features in between (1 or less: every evaluation whole)."""
        if cross_attention_kwargs:
            call_kw = {k: v for k, v in locals().items()
                       if k not in ("self", "cross_attention_kwargs")}
            return self._with_lora_scale(cross_attention_kwargs,
                                         lambda: self(**call_kw))
        if height is not None or width is not None:
            image, mask = apply_target_hw(image, mask, height, width,
                                          isinstance(prompt, (list, tuple)))
        req = self._request(image, mask, prompt, negative_prompt, task,
                            fitting_degree, num_inference_steps,
                            guidance_scale, strength, seed,
                            num_images_per_prompt, output_type, clip_skip,
                            scheduler)
        self._set_step_callback(callback, callback_steps, self.step_callback)
        return self._run(req, num_inference_steps, output_type, eta, latents,
                         clip_skip, encoder_cache_interval=int(encoder_cache_interval),
                         **self._embeds(req, prompt_embeds, negative_prompt_embeds))

    def _embeds(self, req: Request, prompt_embeds,
                negative_prompt_embeds) -> dict:
        """``_generate``'s embedding arguments for a caller's arrays."""
        b = req.images.shape[0]
        return dict(
            prompt_embeds=embeds_rows(norm_embeds(prompt_embeds), b,
                                      self.device),
            negative_prompt_embeds=embeds_rows(
                norm_embeds(negative_prompt_embeds), b, self.device))

    def _request(self, image, mask, prompt, negative_prompt, task: str,
                 fitting_degree, num_inference_steps: int, guidance_scale,
                 strength: float, seed, num_images_per_prompt: int,
                 output_type: str, clip_skip: int, scheduler: str = "ddim",
                 **window) -> Request:
        """Validate and batch one call on the host (``window``: the
        ControlNet guidance window, checked with the rest)."""
        multi = isinstance(prompt, (list, tuple))
        prompts = list(prompt) if multi else [prompt]
        negatives = as_list(negative_prompt, len(prompts))
        fittings = as_list(fitting_degree, len(prompts))
        guidances = as_list(guidance_scale, len(prompts))
        img_b, mask_b = batch_inputs(
            image, mask, multi, len(prompts) if multi else num_images_per_prompt)
        b = img_b.shape[0]
        self._check_rows(img_b.shape[1])
        for f, g in zip(fittings, guidances):
            check_call_args(task=task, num_inference_steps=num_inference_steps,
                            guidance_scale=float(g), strength=strength,
                            fitting_degree=float(f), **window)
        check_output_type(output_type)
        check_clip_skip(clip_skip, self.config.text_encoder.num_hidden_layers)
        check_scheduler(scheduler, self.config.scheduler, num_inference_steps)
        if len(guidances) != b:
            guidances = [guidances[0]] * b
        ids = np.stack([self.encode_task(add_task(p, n, task, "ppt-v1"))
                        for p, n in zip(prompts, negatives)])
        strength_steps = min(int(num_inference_steps * strength),
                             num_inference_steps)
        return Request(img_b, mask_b, ids, fittings, guidances,
                       resolve_seeds(seed, b), strength_steps, scheduler)

    def _run(self, req: Request, num_inference_steps: int, output_type: str,
             eta: float, latents: Optional[np.ndarray], clip_skip: int,
             **extra) -> np.ndarray:
        """Draw the noise, run ``_generate`` (with ``extra``, the keyword
        arguments a subclass's ``_generate`` adds) and ``finish`` under the
        telemetry stage ``generate``, and count the images and steps. On a
        mesh this rank runs its share of the images, or under sequence
        parallelism its rows of every image (``MeshMixin``)."""
        b, h, w, _ = req.images.shape
        share = self._share(b)
        if share is not None:
            req, latents, extra = self._shard(req, latents, extra, share)
        mod, sched = make_sampler(req.scheduler, self.config.scheduler,
                                  num_inference_steps, req.strength_steps)
        n_draws = sched.num_steps if takes_step_noise(mod, float(eta)) else 0
        noise0, vae_noise, img_noise, step_noise = self._draw_noise(
            req.seeds, (h // 8, w // 8, 4), n_draws)
        if self._sp:  # each image's rows, its noise drawn whole then cut
            req, latents, extra = self._shard_rows(req, latents, extra)
            noise0, vae_noise, img_noise = (
                self._rows(t) for t in (noise0, vae_noise, img_noise))
            if step_noise is not None:
                step_noise = [self._rows(t) for t in step_noise]

        dev = self.device
        telemetry.reset_stages()
        with telemetry.stage("generate"):
            with self._sp_scope():
                out = self._generate(
                    to_device(req.ids, dev, torch.long),
                    to_device(np.asarray(req.fittings, np.float32), dev),
                    to_device(req.images, dev),
                    to_device(req.masks, dev),
                    to_device(np.asarray(req.guidances, np.float32), dev),
                    noise0, vae_noise, img_noise, step_noise,
                    num_steps=num_inference_steps,
                    strength_steps=req.strength_steps, output_type=output_type,
                    eta=float(eta),
                    latents_in=(None if latents is None
                                else to_device(latents, dev)),
                    clip_skip=int(clip_skip), scheduler=req.scheduler,
                    **extra)
            out = finish(self._gather(out))
        self._calls += 1
        telemetry.count("images", b)
        telemetry.count("denoise_steps", req.strength_steps)
        return out

    @staticmethod
    def _shard(req: Request, latents, extra: dict, share: slice):
        """A request's rows ``share`` (``MeshMixin``): its images, masks,
        guidances and seeds, its prompts where it has one per image, the
        caller's latents and embeddings, and the ControlNet's control
        images (N, B, ...)."""
        b = req.images.shape[0]
        per_image = len(req.ids) == b
        req = req._replace(
            images=req.images[share], masks=req.masks[share],
            ids=req.ids[share] if per_image else req.ids,
            fittings=req.fittings[share] if per_image else req.fittings,
            guidances=req.guidances[share], seeds=req.seeds[share])
        extra = dict(extra)
        for k in ("prompt_embeds", "negative_prompt_embeds"):
            extra[k] = rows(extra.get(k), share, b)
        if extra.get("control_u8") is not None:
            extra["control_u8"] = extra["control_u8"][:, share]
        return req, rows(latents, share, b), extra

    def _shard_rows(self, req: Request, latents, extra: dict):
        """A request's rows of each image under sequence parallelism
        (``MeshMixin``): its images, masks, the caller's latents and the
        ControlNet's control images (N, B, H, W, 3); the rest whole."""
        req = req._replace(images=self._rows(req.images),
                           masks=self._rows(req.masks))
        extra = dict(extra)
        if extra.get("control_u8") is not None:
            extra["control_u8"] = self._rows(extra["control_u8"], dim=2)
        return req, self._rows(latents), extra
