"""ppt-v2 pipeline: BrushNet dual-branch inpainting with preserved
cross-attention, sampled with UniPC by default or any registry sampler.

The port of ``powerpaint_tpu/pipelines/brushnet.py`` on PyTorch:

- two text towers: the BrushNet branch sees the task-token embeddings
  (``text_encoder_brushnet``: prompts A, B and the two negatives, blended
  by the fitting degree), the frozen base UNet the plain prompt pair
  (``text_encoder``: promptU and its negative);
- 5-channel conditioning: the VAE sample of the pre-masked image (hole
  pixels black) times the scaling factor, then the keep mask (1 on
  preserved pixels) resized nearest to the latent grid;
- per sampler iteration, one BrushNet forward (CFG batch 2B, task
  embeddings) giving 28 taps, one base-UNet forward (2B, plain
  embeddings) with the taps injected, the guidance combine and a sampler
  step (a Python loop where the JAX package has ``lax.scan``); both
  forwards see the sampler's scaled latents;
- ``control_guidance_start`` / ``_end`` gate the branch per step through a
  host table of conditioning scales (on heun's iterations, its step's
  row);
- ``branch_cache_interval`` n > 1: the branch runs on every n-th
  iteration only and the others reuse its 28 taps (the encoder-propagation
  argument applied to the whole branch, as in the JAX package);
- an LCM-distilled UNet (``time_cond_proj_dim`` set) gets the guidance
  embedding of w - 1 as ``timestep_cond`` at every evaluation, one row per
  image of the CFG batch;
- IP-Adapter (the reference's ``ip_adapter_image`` /
  ``ip_adapter_image_embeds``, pipeline_PowerPaint_Brushnet_CA.py:629-707):
  an image is resized bicubic to the image tower's input, CLIP-normalised
  and encoded (``image_encoder``, one image per call of the tower); each
  adapter's embedding, tiled to the batch, becomes the CFG pair [zeros |
  embeds] that the base UNet alone takes on every evaluation, with
  ``ip_adapter_scale`` (a float or one per adapter).

The call surface of the reference's pipeline: ``prompt_embeds`` /
``negative_prompt_embeds`` replace the branch's task-blended pair (the
base UNet's plain tower still encodes; with both given the task tower does
not run), ``callback`` / ``callback_steps`` observe the loop
(``pipelines.common.StepCallbackMixin``), ``height`` / ``width`` resize the
inputs first, and ``timesteps=`` (UniPC only) gives the sampler's grid.

Randomness: per-image ``torch.Generator`` draws in the order
``pipelines.common`` documents (the initial latent noise, the VAE sample
noise of the masked image, then a stochastic sampler's step noise), so a
batched request reproduces each standalone result. ``_generate`` takes
the draws as tensors, so a test can hand in the JAX package's threefry
streams.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from powerpaint_tpu_torch.core.config import PowerPaintConfig
from powerpaint_tpu_torch.core.metrics import GLOBAL as telemetry
from powerpaint_tpu_torch.core.validation import (
    InputValidationError,
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
    cfg_rows,
    cond_scale_table,
    draw_noise,
    embeds_rows,
    int8_x_scale,
    make_sampler,
    norm_embeds,
    per_iteration,
    pipeline_device,
    resolve_seeds,
    resolve_timesteps,
    rows,
    sampler_step,
    step_timesteps,
    table_row,
    takes_step_noise,
    to_device,
    to_output,
    vae_sample,
)
from powerpaint_tpu_torch.models.layers import guidance_scale_embedding
from powerpaint_tpu_torch.tasks.preprocess import to_numpy_image
from powerpaint_tpu_torch.text.prompts import TaskPrompts, add_task, v2_prompt_suffix


class BrushNetPipeline(AotPipelineMixin, AsyncDispatchMixin, LoraMixin,
                       MeshMixin, StepCallbackMixin):
    """``BrushNetPipeline(config, state, tokenizer)(image, mask, prompt)``.

    ``state`` holds one diffusers / transformers named state dict per family
    (``unet``, ``vae``, ``brushnet``, ``text_encoder`` (plain) and
    ``text_encoder_brushnet`` (task tokens), and ``image_encoder`` when
    ``config.image_encoder`` is set), tensors or numpy arrays. An
    IP-Adapter's weights are in ``unet`` (``io.convert.convert_ip_adapter``)
    when ``config.unet.ip_adapter_dim`` is set.
    Linear and conv weights run in ``dtype``; norm parameters stay fp32. The
    models live on ``device`` (the card unless the caller asks for
    ``"cpu"``).
    ``int8=True`` runs the ResNet units the JAX package quantises as the
    static-scale int8 W8A8 kernel (``pipelines.common.int8_x_scale``;
    ``None`` reads ``POWERPAINT_INT8`` here, once). ``submit(...)`` and
    ``aot_dump`` / ``aot_load`` as on the ppt-v1 pipeline; ``mesh``,
    ``sequence_parallel`` and ``sp_min_seq`` as there (under sequence
    parallelism the BrushNet branch and the base UNet run on each rank's
    rows, and the IP-Adapter's image tower whole).
    """

    def __init__(self, config: PowerPaintConfig, state: Dict[str, dict],
                 tokenizer, dtype: torch.dtype = torch.bfloat16,
                 device=None, int8: Optional[bool] = None, mesh=None,
                 sequence_parallel: bool = False, sp_min_seq: int = 2048):
        if config.brushnet is None:
            raise ValueError("BrushNetPipeline needs a config with a brushnet "
                             "(ppt_v2_config)")
        self.config = config
        self.sequence_parallel = bool(sequence_parallel)
        self.sp_min_seq = int(sp_min_seq)
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
        self.brushnet = models["brushnet"]
        self.text_encoder = models["text_encoder"]
        self.text_encoder_brushnet = models["text_encoder_brushnet"]
        self.image_encoder = models.get("image_encoder")

    # ------------------------------------------------------------ stages

    def encode_task(self, prompts: TaskPrompts) -> Tuple[np.ndarray, np.ndarray]:
        """Token ids: (4, 77) [A, B, negA, negB] and (2, 77) [U, negU]."""
        return (self.tokenizer([prompts.promptA, prompts.promptB,
                                prompts.negative_promptA,
                                prompts.negative_promptB]),
                self.tokenizer([prompts.promptU, prompts.negative_promptU]))

    def _encode_prompts(self, ids_task: torch.Tensor, ids_plain: torch.Tensor,
                        fittings: torch.Tensor, b: int, clip_skip: int,
                        pos_in: Optional[torch.Tensor] = None,
                        neg_in: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """ids_task (P, 4, 77), ids_plain (P, 2, 77) -> the CFG contexts
        (2B, 77, D) [negatives; positives] of the branch (task embeddings,
        each pair blended ``A * t + (1 - t) * B``, float32) and of the base
        UNet (plain embeddings; ``clip_skip`` applies to this tower).
        ``pos_in`` / ``neg_in`` (B, 77, D) float32 replace the branch's
        halves; with both the task tower does not run."""
        p, _, s = ids_task.shape
        if pos_in is None or neg_in is None:
            emb = self.text_encoder_brushnet(ids_task.reshape(p * 4, s))
            emb = emb.reshape(p, 4, s, -1)
            t = fittings.reshape(-1, 1, 1)
            pos_t = emb[:, 0] * t + (1.0 - t) * emb[:, 1]
            neg_t = emb[:, 2] * t + (1.0 - t) * emb[:, 3]
            if p != b:  # one prompt, several images
                pos_t, neg_t = (e.repeat_interleave(b // p, dim=0)
                                for e in (pos_t, neg_t))
        pos_t = pos_t if pos_in is None else pos_in
        neg_t = neg_t if neg_in is None else neg_in
        plain = self.text_encoder(ids_plain.reshape(p * 2, s),
                                  clip_skip=clip_skip).reshape(p, 2, s, -1)
        pos_u, neg_u = plain[:, 0], plain[:, 1]
        if p != b:
            pos_u, neg_u = (e.repeat_interleave(b // p, dim=0)
                            for e in (pos_u, neg_u))
        return torch.cat([neg_t, pos_t]), torch.cat([neg_u, pos_u])

    def _vae_sample(self, images: torch.Tensor,
                    noise: torch.Tensor) -> torch.Tensor:
        return vae_sample(self.vae, images, noise,
                          self.config.vae.scaling_factor)

    def _branch(self, scaled: torch.Tensor, t: torch.Tensor,
                cond_task: torch.Tensor, cond5: torch.Tensor, scale: float,
                guess_mode: bool):
        """The BrushNet taps for the CFG batch from the sampler's scaled
        latents (B, h, w, 4). In guess mode the branch sees only the
        conditional half; the other half's taps are zero."""
        b = scaled.shape[0]
        if not guess_mode:
            return self.brushnet(scaled.repeat(2, 1, 1, 1), t, cond_task,
                                 cond5, scale)
        down, mid, up = self.brushnet(scaled, t, cond_task[b:], cond5[:b],
                                      scale, guess_mode=True)
        pad = lambda x: torch.cat([torch.zeros_like(x), x])  # noqa: E731
        return [pad(x) for x in down], pad(mid), [pad(x) for x in up]

    def _denoise(self, mod, sched, latents: torch.Tensor, cond5: torch.Tensor,
                 cond_task: torch.Tensor, cond_plain: torch.Tensor,
                 guidance: torch.Tensor, scales: np.ndarray, guess_mode: bool,
                 step_noise=None,
                 timestep_cond: Optional[torch.Tensor] = None,
                 branch_cache_interval: int = 1, ip_embeds=None,
                 ip_scale=1.0) -> torch.Tensor:
        """The sampler ``mod``'s loop: each iteration the branch's taps,
        then the base UNet on the scaled latents for the unconditional and
        the conditional half in one batch (with the IP-Adapter pairs
        ``ip_embeds`` and ``ip_scale``, as the UNet takes them). With
        ``branch_cache_interval`` n > 1 the branch runs at iterations i
        with i % n == 0 and the others take the taps it gave there."""
        b = latents.shape[0]
        state = mod.init_state(sched, latents.shape, latents.device)
        timesteps = step_timesteps(sched, latents.device)
        for i in range(sched.num_steps):
            scaled = mod.scale_model_input(sched, latents, i)
            t = timesteps[i]
            if branch_cache_interval <= 1 or i % branch_cache_interval == 0:
                taps = self._branch(scaled, t, cond_task, cond5,
                                    float(table_row(scales, i)), guess_mode)
            down, mid, up = taps
            eps = self.unet(scaled.repeat(2, 1, 1, 1), t, cond_plain,
                            down_block_add_samples=down,
                            mid_block_add_sample=mid, up_block_add_samples=up,
                            timestep_cond=timestep_cond,
                            image_embeds=ip_embeds, ip_scale=ip_scale).float()
            eps = eps[:b] + guidance * (eps[b:] - eps[:b])
            self._run_step_callback(i, latents)
            latents, state = sampler_step(mod, sched, state, eps, i, latents,
                                          0.0, step_noise)
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
                  vae_noise: torch.Tensor, step_noise=None, *, num_steps: int,
                  output_type: str, guess_mode: bool = False,
                  latents_in: Optional[torch.Tensor] = None,
                  clip_skip: int = 0, scheduler: str = "unipc",
                  timesteps: Optional[Sequence[int]] = None,
                  prompt_embeds: Optional[torch.Tensor] = None,
                  negative_prompt_embeds: Optional[torch.Tensor] = None,
                  branch_cache_interval: int = 1, ip_embeds=None,
                  ip_scale=1.0) -> torch.Tensor:
        """Everything after host-side validation, on ``self.device``.

        ids_task (P, 4, 77); ids_plain (P, 2, 77); fittings (P,); image_u8
        (B, H, W, 3) uint8; mask_u8 (B, H, W, 1) uint8, 255 in the hole;
        guidance (B,); scales the branch's scale per step, on the sampler's
        iterations (``per_iteration``); noise0 and vae_noise (B, H/8, W/8,
        4) fp32; step_noise one (B, H/8, W/8, 4) tensor per iteration for a
        stochastic sampler, else None; ``timesteps`` UniPC's grid in place of
        the spacing formula (``num_steps`` its length); ``prompt_embeds`` /
        ``negative_prompt_embeds`` (B, 77, D) float32 or None, as
        ``_encode_prompts`` takes them; ``branch_cache_interval``,
        ``ip_embeds`` (a (2B, ip_adapter_dim) CFG pair, or a list of them,
        one per adapter) and ``ip_scale`` as ``_denoise`` takes them."""
        mod, sched = make_sampler(scheduler, self.config.scheduler, num_steps,
                                  custom_timesteps=timesteps)
        b, h, w, _ = image_u8.shape
        keep = 1.0 - (mask_u8 >= 128).float()
        masked_image = image_u8.float() * keep / 127.5 - 1.0

        cond_task, cond_plain = self._encode_prompts(
            ids_task, ids_plain, fittings, b, clip_skip, prompt_embeds,
            negative_prompt_embeds)
        cond_lat = self._vae_sample(masked_image, vae_noise)
        # half-pixel-centre nearest, as jax.image.resize(..., "nearest")
        keep8 = F.interpolate(keep.permute(0, 3, 1, 2), size=(h // 8, w // 8),
                              mode="nearest-exact").permute(0, 2, 3, 1)
        cond5 = torch.cat([cond_lat, keep8], dim=-1).repeat(2, 1, 1, 1)
        if latents_in is not None:
            latents = latents_in.float() * sched.init_noise_sigma
        else:
            latents = noise0 * sched.init_noise_sigma
        timestep_cond = None
        if self.config.unet.time_cond_proj_dim:
            g = guidance.float().reshape(-1)
            g = g.expand(b) if g.shape[0] == 1 else g
            timestep_cond = guidance_scale_embedding(
                torch.cat([g, g]) - 1.0, self.config.unet.time_cond_proj_dim)

        latents = self._denoise(mod, sched, latents, cond5, cond_task,
                                cond_plain,
                                guidance.float().reshape(-1, 1, 1, 1), scales,
                                guess_mode, step_noise, timestep_cond,
                                branch_cache_interval, ip_embeds, ip_scale)
        if output_type == "latent":
            return latents
        return to_output(self._decode(latents), output_type)

    @torch.no_grad()
    def _encode_one_ip_image(self, image) -> torch.Tensor:
        """One IP-Adapter reference image (PIL or array) -> its projected
        CLIP embedding (1, projection_dim) float32 on the device: a PIL
        bicubic resize to the tower's input, CLIP normalisation (the safety
        checker's constants), the tower."""
        from PIL import Image

        from powerpaint_tpu_torch.core.safety import CLIP_MEAN, CLIP_STD

        s = self.config.image_encoder.image_size
        pix = np.asarray(Image.fromarray(to_numpy_image(image)).resize(
            (s, s), Image.BICUBIC), dtype=np.float32)
        pix = (pix / 255.0 - CLIP_MEAN) / CLIP_STD
        return self.image_encoder(to_device(pix[None], self.device)).float()

    def _ip_pairs(self, image, embeds, b: int):
        """The UNet's ``image_embeds``: one CFG pair (2B, D) [zeros |
        embeds] per adapter, from the call's ``ip_adapter_image`` or
        ``ip_adapter_image_embeds`` (one value or a list, one per adapter;
        an embedding (D,), (1, D) or (B, D)), in the form given, or None."""
        if image is not None and embeds is not None:
            raise InputValidationError(
                "provide either ip_adapter_image or "
                "ip_adapter_image_embeds, not both")
        if image is not None and self.image_encoder is None:
            raise InputValidationError(
                "ip_adapter_image needs an image encoder: set "
                "config.image_encoder and state['image_encoder']")
        given = image if image is not None else embeds
        if given is None:
            return None
        many = isinstance(given, (list, tuple))
        n = len(given) if many else 1
        if n > len(self.config.unet.ip_adapters):
            raise InputValidationError(
                f"{n} IP-Adapter embeddings for a UNet with "
                f"{len(self.config.unet.ip_adapters)} adapters "
                "(config.unet.ip_adapter_dim / ip_adapter_tokens)")
        if image is not None:
            embeds = [self._encode_one_ip_image(im)
                      for im in (image if many else [image])]
        else:
            embeds = list(embeds) if many else [embeds]
        pairs = []
        for e in embeds:
            e = to_device(e.float() if torch.is_tensor(e)
                          else np.asarray(e, np.float32), self.device)
            e = e.reshape(1, -1) if e.dim() == 1 else e
            if e.shape[0] not in (1, b) or e.shape[1] != \
                    self.config.unet.ip_adapter_dim:
                raise InputValidationError(
                    f"an IP-Adapter embedding of shape {tuple(e.shape)} for "
                    f"{b} images of ip_adapter_dim "
                    f"{self.config.unet.ip_adapter_dim}")
            e = e.expand(b, -1)
            pairs.append(torch.cat([torch.zeros_like(e), e]))
        return pairs if many else pairs[0]

    def __call__(self, image, mask, prompt="", negative_prompt="",
                 task: str = "text-guided", fitting_degree=1.0,
                 num_inference_steps: int = 45, guidance_scale=7.5,
                 brushnet_conditioning_scale: float = 1.0,
                 control_guidance_start: float = 0.0,
                 control_guidance_end: float = 1.0, seed=0,
                 num_images_per_prompt: int = 1, guess_mode: bool = False,
                 branch_cache_interval: int = 1,
                 latents: Optional[np.ndarray] = None,
                 output_type: str = "uint8", clip_skip: int = 0,
                 scheduler: str = "unipc",
                 prompt_embeds: Optional[np.ndarray] = None,
                 negative_prompt_embeds: Optional[np.ndarray] = None,
                 callback: Optional[Callable] = None, callback_steps: int = 1,
                 height: Optional[int] = None, width: Optional[int] = None,
                 timesteps: Optional[Sequence[int]] = None,
                 ip_adapter_image=None, ip_adapter_image_embeds=None,
                 ip_adapter_scale=1.0,
                 cross_attention_kwargs: Optional[dict] = None) -> np.ndarray:
        """Inpaint ``image`` (H, W, 3) where ``mask`` (H, W) is 1.

        Batched form: ``prompt`` a list of B prompts, with ``image`` /
        ``mask`` either one pair for all or B stacked pairs, and
        ``negative_prompt`` / ``fitting_degree`` / ``guidance_scale`` /
        ``seed`` one value or one per request. ``scheduler`` is any registry
        sampler. Returns (B, H, W, 3) uint8, (B, H, W, 3) float32 in [-1, 1]
        or (B, H/8, W/8, 4) float32 latents, as numpy.
        ``cross_attention_kwargs={"scale": s}``: the loaded LoRA's scale for
        this call alone (``LoraMixin``).

        ``prompt_embeds`` / ``negative_prompt_embeds``: (B|1, 77, D) or (77,
        D) arrays in place of the branch's task-blended pair;
        ``callback(i, latents)`` every ``callback_steps`` iterations
        (``StepCallbackMixin``); ``height`` and ``width`` (together) resize
        the image and mask first; ``timesteps``: a strictly descending list
        of ints in [0, T), UniPC only, that replaces ``num_inference_steps``
        and its spacing; ``branch_cache_interval`` n > 1: the BrushNet
        branch runs every n-th iteration and its taps serve the ones
        between (1 or less: every iteration).

        IP-Adapter: ``ip_adapter_image`` (an image, or one per adapter) is
        encoded by the image tower; ``ip_adapter_image_embeds`` gives the
        embeddings instead ((D,), (1, D) or (B, D) each); not both.
        ``ip_adapter_scale``: a float or one per adapter (0 leaves the
        image as without the adapter)."""
        if cross_attention_kwargs:
            call_kw = {k: v for k, v in locals().items()
                       if k not in ("self", "cross_attention_kwargs")}
            return self._with_lora_scale(cross_attention_kwargs,
                                         lambda: self(**call_kw))
        custom_ts = None
        if timesteps is not None:
            check_scheduler(scheduler, self.config.scheduler, 1)
            custom_ts = resolve_timesteps(scheduler, self.config.scheduler,
                                          timesteps)
            num_inference_steps = len(custom_ts)
        multi = isinstance(prompt, (list, tuple))
        if height is not None or width is not None:
            image, mask = apply_target_hw(image, mask, height, width, multi)
        prompts = list(prompt) if multi else [prompt]
        negatives = as_list(negative_prompt, len(prompts))
        fittings = as_list(fitting_degree, len(prompts))
        guidances = as_list(guidance_scale, len(prompts))
        mod = check_scheduler(scheduler, self.config.scheduler,
                              num_inference_steps)
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
        self._check_rows(h)
        if len(guidances) != b:
            guidances = [guidances[0]] * b
        seeds = resolve_seeds(seed, b)
        ip_embeds = self._ip_pairs(ip_adapter_image, ip_adapter_image_embeds,
                                   b)

        ids = [self.encode_task(add_task(v2_prompt_suffix(p, task), n, task,
                                         "ppt-v2"))
               for p, n in zip(prompts, negatives)]
        ids_task = np.stack([t for t, _ in ids])
        # a user token's ids lie past the plain tower's table; they read its
        # last row, as the JAX package's gather clamps them
        ids_plain = np.minimum(np.stack([u for _, u in ids]),
                               self.config.text_encoder.vocab_size - 1)
        scales = per_iteration(mod, cond_scale_table(
            num_inference_steps, float(brushnet_conditioning_scale),
            control_guidance_start, control_guidance_end))
        prompt_embeds = embeds_rows(norm_embeds(prompt_embeds), b, self.device)
        negative_prompt_embeds = embeds_rows(
            norm_embeds(negative_prompt_embeds), b, self.device)
        share = self._share(b)
        if share is not None:  # this rank's images (MeshMixin)
            if len(ids_task) == b:
                ids_task, ids_plain = ids_task[share], ids_plain[share]
                fittings = fittings[share]
            img_b, mask_b = img_b[share], mask_b[share]
            guidances, seeds = guidances[share], seeds[share]
            latents = rows(latents, share, b)
            prompt_embeds = rows(prompt_embeds, share, b)
            negative_prompt_embeds = rows(negative_prompt_embeds, share, b)
            ip_embeds = cfg_rows(ip_embeds, share, b)
        _, sched = make_sampler(scheduler, self.config.scheduler,
                                num_inference_steps, custom_timesteps=custom_ts)
        n_draws = sched.num_steps if takes_step_noise(mod) else 0
        noise0, vae_noise, *step_noise = draw_noise(
            self.device, seeds, (h // 8, w // 8, 4), 2 + n_draws)
        if self._sp:  # each image's rows, its noise drawn whole then cut
            img_b, mask_b, latents = (self._rows(x)
                                      for x in (img_b, mask_b, latents))
            noise0, vae_noise = self._rows(noise0), self._rows(vae_noise)
            step_noise = [self._rows(t) for t in step_noise]

        dev = self.device
        self._set_step_callback(callback, callback_steps)
        telemetry.reset_stages()
        with telemetry.stage("generate"):
            with self._sp_scope():
                out = self._generate(
                    to_device(ids_task, dev, torch.long),
                    to_device(ids_plain, dev, torch.long),
                    to_device(np.asarray(fittings, np.float32), dev),
                    to_device(img_b, dev),
                    to_device(mask_b, dev),
                    to_device(np.asarray(guidances, np.float32), dev),
                    scales, noise0, vae_noise, step_noise or None,
                    num_steps=num_inference_steps, output_type=output_type,
                    guess_mode=bool(guess_mode),
                    latents_in=(None if latents is None
                                else to_device(latents, dev)),
                    clip_skip=int(clip_skip), scheduler=scheduler,
                    timesteps=custom_ts,
                    branch_cache_interval=int(branch_cache_interval),
                    prompt_embeds=prompt_embeds,
                    negative_prompt_embeds=negative_prompt_embeds,
                    ip_embeds=ip_embeds, ip_scale=ip_adapter_scale)
            out = finish(self._gather(out))
        self._calls += 1
        telemetry.count("images", b)
        telemetry.count("denoise_steps", num_inference_steps)
        return out
