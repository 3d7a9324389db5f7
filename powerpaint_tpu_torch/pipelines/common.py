"""What the ppt-v1, ppt-v2 and ControlNet pipelines share: the int8 option,
request batching, seeds and the branches' gating tables on the host,
per-image noise, the sampler's step, the VAE sample and the decode; and
the call surface they share with the reference's diffusers pipelines:
``prompt_embeds`` (``norm_embeds``), ``callback`` / ``callback_steps``
(``StepCallbackMixin``) and ``height`` / ``width`` (``apply_target_hw``).

Randomness: each image has its own ``torch.Generator`` seeded with its
seed, and ``draw_noise`` takes every draw of a call from it, in this
order, each a (H/8, W/8, 4) standard normal:

1. the initial latent noise;
2. the VAE sample noise of the masked image;
3. (ppt-v1 and ControlNet) the VAE sample noise of the image latents;
4. the step noise, one draw per sampler iteration (one UNet evaluation:
   heun's 2S-1, pndm's S+1), when the sampler takes it: the stochastic
   samplers (euler_a, dpm_sde, lcm; ``stochastic = True``) and, on
   ppt-v1 and ControlNet, DDIM with ``eta`` > 0.

So a batched request draws exactly what each of its images draws alone.
The numbers differ from the JAX package's threefry streams (folds 0, 1, 2
of each image's key, then fold 4 for the step noise, or fold 3 of the
first image's key for DDIM's eta); the pipelines' ``_generate`` takes the
draws as tensors, so a test can hand both packages the same noise.
"""

from __future__ import annotations

import contextlib
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from powerpaint_tpu_torch import schedulers
from powerpaint_tpu_torch.core.validation import (
    InputValidationError,
    check_image_mask,
)
from powerpaint_tpu_torch.parallel import sequence
from powerpaint_tpu_torch.schedulers import ddim, unipc
from powerpaint_tpu_torch.schedulers.common import custom_timesteps_array
from powerpaint_tpu_torch.tasks.preprocess import (
    resize_to,
    to_numpy_image,
    to_numpy_mask,
)


def int8_x_scale(int8: Optional[bool]) -> Optional[float]:
    """The static activation scale of the int8 W8A8 path, or None when it
    is off: the one place the port reads the option. ``int8=None`` reads the
    JAX package's environment: ``POWERPAINT_INT8`` exactly "1" turns it on,
    and the scale is ``POWERPAINT_INT8_XSCALE`` (default 8.0, the post-SiLU
    range it calibrates) over 127."""
    if int8 is None:
        int8 = os.environ.get("POWERPAINT_INT8", "0") == "1"
    if not int8:
        return None
    return float(os.environ.get("POWERPAINT_INT8_XSCALE", "8.0")) / 127.0


def as_list(value, n: int) -> list:
    return list(value) if isinstance(value, (list, tuple)) else [value] * n


def batch_inputs(image, mask, multi: bool,
                 n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(B, H, W, 3) uint8 images and (B, H, W, 1) uint8 masks (255 in the
    hole): B stacked pairs for a batched request that brings them, else
    one pair tiled ``n`` times."""
    if multi and np.asarray(image).ndim == 4:
        img_b = np.stack([to_numpy_image(im) for im in image])
        masks = [to_numpy_mask(m) for m in mask]
        for im, m in zip(img_b, masks):
            check_image_mask(im, m)
        mask_b = np.stack([(m >= 0.5).astype(np.uint8)[..., None] * 255
                           for m in masks])
        return img_b, mask_b
    img = to_numpy_image(image)
    msk = to_numpy_mask(mask)
    check_image_mask(img, msk)
    img_b = np.tile(img[None], (n, 1, 1, 1))
    mask_b = np.tile((msk >= 0.5).astype(np.uint8)[None, ..., None] * 255,
                     (n, 1, 1, 1))
    return img_b, mask_b


def resolve_seeds(seed, b: int) -> List[int]:
    """One seed per image: a list as given, or an int and the ones after
    it (one request, several images)."""
    if isinstance(seed, (list, tuple)):
        seeds = [int(s) for s in seed]
    else:
        seeds = [int(seed) + i for i in range(b)]
    if len(seeds) != b:
        raise ValueError(f"{len(seeds)} seeds for {b} images")
    return seeds


def cond_scale_table(num_steps: int, scale: float, start: float,
                     end: float) -> np.ndarray:
    """A branch's conditioning scale per step: ``scale`` inside the
    [start, end] window of the schedule, 0 outside."""
    keeps = np.array([1.0 - float(i / num_steps < start
                                  or (i + 1) / num_steps > end)
                      for i in range(num_steps)], np.float32)
    return keeps * scale


def make_sampler(name: str, scheduler_config, num_steps: int,
                 keep_steps: Optional[int] = None,
                 custom_timesteps: Optional[Sequence[int]] = None):
    """(module, schedule) of the registry sampler ``name``; ``keep_steps``
    < ``num_steps`` keeps the last steps (strength < 1). ``custom_timesteps``
    (UniPC only, ``resolve_timesteps``) replaces the spacing formula."""
    mod, make = schedulers.get(name)
    if custom_timesteps is not None:
        if mod is not unipc:
            raise ValueError(f"custom timesteps on the {name!r} sampler")
        return mod, unipc.make_unipc_schedule(
            scheduler_config, len(custom_timesteps),
            custom_timesteps=custom_timesteps)
    keep = keep_steps if keep_steps is not None and keep_steps < num_steps else None
    return mod, make(scheduler_config, num_steps, keep_steps=keep)


def resolve_timesteps(scheduler: str, scheduler_config,
                      timesteps) -> Tuple[int, ...]:
    """A caller's ``timesteps`` list checked on the host (UniPC only, the
    JAX package's rule and messages) as a tuple of ints."""
    if scheduler.lower() != "unipc":
        raise InputValidationError(
            "explicit timesteps= lists are only supported with the "
            "unipc scheduler on the v2 pipeline")
    try:
        return tuple(int(t) for t in
                     custom_timesteps_array(scheduler_config, timesteps))
    except ValueError as e:
        raise InputValidationError(str(e)) from e


def to_device(array, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A host array (or CPU tensor) as a tensor on ``device`` without
    waiting on the card: on a card, staged in pinned host memory and copied
    with ``non_blocking`` on the current stream (the caching host allocator
    keeps the pinned block until the copy's event completes); on the CPU,
    or from a device tensor, ``.to(device)``. ``torch.as_tensor(array,
    device="cuda")`` copies from pageable memory and waits for the stream
    to drain."""
    t = torch.as_tensor(array, dtype=dtype)
    if torch.device(device).type != "cuda" or t.device.type != "cpu":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def step_timesteps(sched, device) -> torch.Tensor:
    """The sampler's timestep at each iteration, one int64 tensor on
    ``device`` uploaded once a call: iteration i takes the 0-dim view
    ``[i]`` (a ``torch.tensor(t, device=...)`` a step would wait on the
    card at every step)."""
    return to_device(np.asarray([int(sched.timesteps[i])
                                 for i in range(sched.num_steps)], np.int64),
                     device)


def norm_embeds(e) -> Optional[np.ndarray]:
    """A caller's ``prompt_embeds`` / ``negative_prompt_embeds`` as (B, 77,
    D) float32 numpy (a (77, D) array is one row), or None."""
    if e is None:
        return None
    e = np.asarray(e, np.float32)
    return e[None] if e.ndim == 2 else e


def embeds_rows(e: Optional[np.ndarray], b: int, device) -> Optional[torch.Tensor]:
    """``norm_embeds``' rows on ``device``, one per image: a single row is
    repeated over the ``b`` images, as the encoded pair is."""
    if e is None:
        return None
    t = to_device(e, device, torch.float32)
    return t.repeat_interleave(b // t.shape[0], dim=0) if t.shape[0] != b else t


def apply_target_hw(image, mask, height, width, multi: bool):
    """The ``height`` / ``width`` call arguments: both or neither, and the
    image (LANCZOS) and mask (NEAREST) resized to exactly (height, width)
    (``tasks.preprocess.resize_to``); a batched call's stacked pairs each."""
    if height is None or width is None:
        raise InputValidationError("height and width must be provided together")
    if multi and isinstance(image, (list, tuple)):
        pairs = [resize_to(to_numpy_image(im), to_numpy_mask(m), int(height),
                           int(width)) for im, m in zip(image, mask)]
        return [p[0] for p in pairs], [p[1] for p in pairs]
    return resize_to(to_numpy_image(image),
                     None if mask is None else to_numpy_mask(mask),
                     int(height), int(width))


def pipeline_device(device, mesh) -> torch.device:
    """A pipeline's device: the card unless the caller asks for another;
    on a mesh, the rank's device (``device``, when given, must be it)."""
    if mesh is None:
        return torch.device(device or "cuda")
    if device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"device {device!r} on a mesh rank whose device is "
                         f"{mesh.device}")
    return mesh.device


class MeshMixin:
    """A pipeline over a ``parallel.mesh.Mesh`` (``mesh``; None: one
    process). Every rank makes the same call with the same arguments
    (SPMD). The models are tensor-parallel over the rank's model group
    (``io.weights.load_models(tp=)``); the images of a call are split over
    its data group, each rank runs its share (its seeds' draws, its CFG
    pairs) and the shares are all-gathered, so every rank returns the whole
    batch. The data axis must divide the batch.

    ``sequence_parallel=True`` on a mesh (the JAX package's
    ``_generate_fn_sp``: one huge canvas): the batch stays whole and each
    rank of the data group holds 1/n of every image's rows (its share of
    the image, the mask, the control images and of the noise, which is
    drawn whole from each seed and then cut) through every model, under
    ``parallel.sequence.row_context`` with ``sp_min_seq`` as the ring's
    threshold; the output's rows are all-gathered, so every rank returns
    the whole images. The image height must split evenly over the data
    group at every latent level (``sequence.check_height``). Without a mesh
    the option does nothing, as in the JAX package."""

    mesh = None
    sequence_parallel = False
    sp_min_seq = 2048

    @property
    def _sp(self) -> bool:
        return self.mesh is not None and bool(self.sequence_parallel)

    def _share(self, b: int) -> Optional[slice]:
        """This rank's images of a batch of ``b`` (None: every image, in
        one process or under sequence parallelism)."""
        if self.mesh is None or self._sp:
            return None
        return self.mesh.data_share(b)

    def _gather(self, out: torch.Tensor) -> torch.Tensor:
        """Every rank's images of a result, in batch order, or every rank's
        rows under sequence parallelism."""
        if self.mesh is None:
            return out
        return self.mesh.data.all_gather(out, 1 if self._sp else 0)

    def _rows(self, x, dim: int = 1):
        """This rank's rows of ``x`` (an array or tensor whole along
        ``dim``, or None) under sequence parallelism, contiguous; else
        ``x``."""
        if x is None or not self._sp:
            return x
        part = sequence.share_rows(x, self.mesh.data, dim)
        return part.contiguous() if torch.is_tensor(part) else \
            np.ascontiguousarray(part)

    def _check_rows(self, h_img: int) -> None:
        """Under sequence parallelism, refuse an image height whose latent
        levels do not split over the data group (the JAX message)."""
        if self._sp:
            sequence.check_height(h_img, self.mesh.data.size,
                                  len(self.config.unet.block_out_channels))

    def _sp_scope(self):
        """The row context of a sequence-parallel call, else nothing."""
        if not self._sp:
            return contextlib.nullcontext()
        return sequence.row_context(self.mesh.data, self.sp_min_seq)


def rows(x, share: slice, b: int):
    """``x``'s rows ``share`` where it has one per image (``b`` leading),
    else ``x`` (None, one row for all)."""
    if x is None or len(x) != b:
        return x
    return x[share]


def cfg_rows(pair, share: slice, b: int):
    """The rows ``share`` of both halves of a CFG pair (2B, ...) [uncond |
    cond], or of each pair of a list."""
    if pair is None:
        return None
    if isinstance(pair, (list, tuple)):
        return [cfg_rows(p, share, b) for p in pair]
    return torch.cat([pair[:b][share], pair[b:][share]])


class StepCallbackMixin:
    """The per-call step callback, the reference's ``callback`` /
    ``callback_steps``: observation only. ``callback(i, latents)`` runs on
    the host after the model evaluation of iteration i, for every i that
    ``callback_steps`` divides, with a float32 numpy copy of the latents
    entering that iteration's sampler step, (B, H/8, W/8, 4) as in the JAX
    package; the copy synchronises with the device, so a call without a
    callback launches and runs as before and a callback cannot change the
    run. ``step_callback`` is the pipeline's default callback (the ppt-v1
    and ControlNet pipelines take it as a constructor argument)."""

    step_callback = None
    _active_callback = None
    _active_callback_steps = 1

    def _set_step_callback(self, callback, callback_steps: int,
                           default=None) -> None:
        self._active_callback = callback or default
        self._active_callback_steps = max(1, int(callback_steps))

    def _run_step_callback(self, i: int, latents: torch.Tensor) -> None:
        cb = self._active_callback
        if cb is not None and int(i) % self._active_callback_steps == 0:
            rows = sequence.current()
            if rows is not None:  # the whole latents, on every rank
                latents = rows.comm.all_gather(latents, 1)
            cb(int(i), latents.to("cpu", torch.float32, copy=True).numpy())


def takes_step_noise(mod, eta: float = 0.0) -> bool:
    """Whether the sampler takes one noise draw per iteration: the
    stochastic samplers, and DDIM with ``eta`` > 0."""
    return bool(getattr(mod, "stochastic", False)) or (mod is ddim and eta > 0.0)


def sampler_step(mod, sched, state, eps: torch.Tensor, i: int,
                 latents: torch.Tensor, eta: float,
                 step_noise: Optional[Sequence[torch.Tensor]]):
    """Iteration i of the sampler: (latents, state). ``eta`` is DDIM's
    alone; ``step_noise`` (one tensor per iteration) reaches the samplers
    that take it."""
    if mod is ddim:
        noise = step_noise[i] if eta > 0.0 else None
        return ddim.step(sched, state, eps, i, latents, eta=eta, noise=noise)
    if getattr(mod, "stochastic", False):
        noise = step_noise[i] if step_noise is not None else None
        return mod.step(sched, state, eps, i, latents, noise=noise)
    return mod.step(sched, state, eps, i, latents)


def per_iteration(mod, table: np.ndarray) -> np.ndarray:
    """A per-user-step table (a branch's gating scales) on the sampler's
    iteration axis: heun's two evaluations a step read their step's row.
    (pndm's extra iteration reads the last row: ``table_row``.)"""
    imap = getattr(mod, "iteration_step_map", None)
    return table[imap(len(table))] if imap is not None else table


def table_row(table: np.ndarray, i: int) -> np.ndarray:
    """Row i of a per-iteration table, the last row past its end (pndm
    runs S+1 iterations over S steps' rows; the JAX package's gather
    clamps the same way)."""
    return table[min(i, len(table) - 1)]


def draw_noise(device, seeds: Sequence[int], shape,
               count: int) -> List[torch.Tensor]:
    """``count`` standard-normal draws of ``shape`` from each image's own
    generator, in order, stacked over the images: a batched request
    reproduces each standalone result."""
    per_image = []
    for seed in seeds:
        g = torch.Generator(device=device).manual_seed(int(seed))
        per_image.append([torch.randn(shape, generator=g, device=device)
                          for _ in range(count)])
    return [torch.stack(d) for d in zip(*per_image)]


def vae_sample(vae, images: torch.Tensor, noise: torch.Tensor,
               scaling_factor: float) -> torch.Tensor:
    """Encode and draw one scaled latent sample per image."""
    mean, logvar = vae.encode(images)
    std = torch.exp(0.5 * logvar.float())
    return (mean.float() + std * noise) * scaling_factor


def to_output(image: torch.Tensor, output_type: str) -> torch.Tensor:
    """A decoded image in [-1, 1] as uint8 or fp32."""
    if output_type == "uint8":
        img01 = torch.clamp(image.float() / 2 + 0.5, 0.0, 1.0)
        return torch.round(img01 * 255.0).to(torch.uint8)
    return image.float()
