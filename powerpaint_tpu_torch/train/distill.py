"""Latent-consistency distillation (LCM / LCM-LoRA, arXiv 2310.04378): the
JAX package's ``train/distill.py``.

Turns the v1 inpainting stack into a few-step consistency model, the
training-side counterpart of schedulers/lcm.py. A LoRA student on a frozen
teacher, a stop-gradient target and no EMA network.

One training step:
  1. sample z0/eps as usual, and the grid index i (t = grid[i]) on the
     COARSE grid schedulers/lcm.py samples at inference;
  2. the teacher runs CFG at a sampled guidance w in [w_min, w_max] and
     takes one DDIM solver step t -> t_prev (one grid point down);
  3. the student (teacher + LoRA) maps BOTH points to the consistency
     output f(x, t) = c_skip(t) x + c_out(t) x0_pred(x, t);
  4. huber(f_student(x_t, t), stopgrad(f_student(x_hat_{t_prev}, t_prev))).

Its draws (``train.loss`` explains why they are explicit): ``lat``,
``mlat``, ``i`` (B,) in [0, grid size), ``eps`` and ``w`` (B,) uniform in
``w_range``; ``draw`` makes them.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from powerpaint_tpu_torch.core.config import PowerPaintConfig
from powerpaint_tpu_torch.schedulers.common import alphas_cumprod
from powerpaint_tpu_torch.schedulers.lcm import SIGMA_DATA
from powerpaint_tpu_torch.train.lora import apply_lora
from powerpaint_tpu_torch.train.loss import (
    batch_tensors,
    build_stack,
    images,
    latent_shape,
    resize_nearest,
    vae_sample,
)


def boundary_scalings(t: torch.Tensor, timestep_scaling: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """c_skip(t), c_out(t): schedulers/lcm.py's tables."""
    s = t.float() * timestep_scaling
    c_skip = SIGMA_DATA ** 2 / (s ** 2 + SIGMA_DATA ** 2)
    c_out = s / torch.sqrt(s ** 2 + SIGMA_DATA ** 2)
    return c_skip, c_out


def ddim_solver_step(x_t, eps, acp, t, t_prev):
    """One deterministic DDIM step t -> t_prev given an eps estimate
    (schedulers/ddim's step with eta = 0)."""
    a_t = acp[t][:, None, None, None]
    a_p = acp[t_prev][:, None, None, None]
    x0 = (x_t - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
    return torch.sqrt(a_p) * x0 + torch.sqrt(1.0 - a_p) * eps


def _huber(x, c: float):
    return torch.sqrt(x * x + c * c) - c


def coarse_grid(config: PowerPaintConfig,
                num_ddim_sections: Optional[int] = None) -> np.ndarray:
    """The ascending coarse grid k-1, 2k-1, ..., T-1 (schedulers/lcm.py)."""
    sched = config.scheduler
    origin = num_ddim_sections or sched.original_inference_steps
    k = sched.num_train_timesteps // origin
    return np.arange(1, origin + 1) * k - 1


def draw(config: PowerPaintConfig, batch, generator: torch.Generator, *,
         w_range: Tuple[float, float] = (4.0, 12.0),
         num_ddim_sections: Optional[int] = None) -> dict:
    """One distillation step's draws from ``generator`` (on its device)."""
    shape = latent_shape(config, batch)
    dev = generator.device
    n = len(coarse_grid(config, num_ddim_sections))
    out = {}
    for name in ("lat", "mlat", "i", "eps", "w"):
        if name == "i":
            out[name] = torch.randint(0, n, (shape[0],), generator=generator,
                                      device=dev)
        elif name == "w":
            out[name] = w_range[0] + (w_range[1] - w_range[0]) * torch.rand(
                (shape[0],), generator=generator, device=dev)
        else:
            out[name] = torch.randn(shape, generator=generator, device=dev)
    return out


def make_lcm_distill_loss(
    config: PowerPaintConfig,
    frozen_params: Dict,
    *,
    dtype: torch.dtype = torch.float32,
    huber_c: float = 0.001,
    num_ddim_sections: Optional[int] = None,
) -> Callable:
    """loss(lora_tree, batch, draws) -> (scalar, metrics): LCM-LoRA
    consistency distillation on the v1 inpainting stack.

    ``frozen_params``: the teacher (unet/vae/text_encoder). The optimized
    tree is a ``train.lora.init_lora_tree`` factor tree over the teacher
    UNet. ``num_ddim_sections`` is the coarse grid size (default: the
    scheduler's ``original_inference_steps``)."""
    m = build_stack(config, dtype)
    sched = config.scheduler
    acp = torch.as_tensor(alphas_cumprod(sched), dtype=torch.float32)
    grid_np = coarse_grid(config, num_ddim_sections)
    sf = config.vae.scaling_factor
    ts_scale = sched.timestep_scaling

    def loss_fn(lora_tree, batch, draws):
        dev = draws["eps"].device
        acp_d = acp.to(dev)
        grid = torch.as_tensor(grid_np, device=dev)
        batch = batch_tensors(batch, dev)
        img, mask = images(batch)
        masked = img * (1.0 - mask)
        b, h, w_, _ = img.shape

        z0 = vae_sample(m["vae_encode"], frozen_params["vae"], img,
                        draws["lat"], sf)
        mlat = vae_sample(m["vae_encode"], frozen_params["vae"], masked,
                          draws["mlat"], sf)
        mask8 = resize_nearest(mask, h // 8, w_ // 8)

        # coarse-grid pairs over the FULL grid incl. the boundary: t =
        # grid[i], t_prev = grid[i-1], and for i == 0 t_prev = 0, where
        # f(x, 0) = x anchors the consistency chain
        i = draws["i"]
        t = grid[i]
        t_prev = torch.where(i > 0, grid[torch.clamp(i - 1, min=0)],
                             torch.zeros_like(t))
        eps = draws["eps"]
        a = acp_d[t][:, None, None, None]
        x_t = torch.sqrt(a) * z0 + torch.sqrt(1.0 - a) * eps

        text = m["text_encoder"]
        ctx_c = text(frozen_params["text_encoder"], batch["ids"].long())
        ctx_u = text(frozen_params["text_encoder"], batch["ids_uncond"].long())

        def nine(x):
            return torch.cat([x, mask8, mlat], dim=-1)

        def consistency_out(params_unet, sample9, tt, ctx):
            e = m["unet"](params_unet, sample9.to(dtype), tt, ctx).float()
            a_t = acp_d[tt][:, None, None, None]
            x = sample9[..., :4].float()
            x0 = (x - torch.sqrt(1.0 - a_t) * e) / torch.sqrt(a_t)
            c_skip, c_out = boundary_scalings(tt, ts_scale)
            return c_out[:, None, None, None] * x0 + c_skip[:, None, None, None] * x

        # ---- teacher: CFG eps at sampled w, one DDIM step down the grid
        wb = draws["w"][:, None, None, None]
        teacher = frozen_params["unet"]
        with torch.no_grad():
            e_c = m["unet"](teacher, nine(x_t).to(dtype), t, ctx_c).float()
            e_u = m["unet"](teacher, nine(x_t).to(dtype), t, ctx_u).float()
            e_cfg = e_u + wb * (e_c - e_u)
            x_prev = ddim_solver_step(x_t, e_cfg, acp_d, t, t_prev)

        # ---- student (teacher + LoRA): consistency outputs at both points
        student = apply_lora(frozen_params["unet"], lora_tree)
        f_online = consistency_out(student, nine(x_t), t, ctx_c)
        with torch.no_grad():
            f_target = consistency_out(student, nine(x_prev), t_prev, ctx_c)

        per = torch.mean(_huber(f_online - f_target, huber_c), dim=(1, 2, 3))
        loss = torch.mean(per)
        return loss, {"loss": loss, "consistency_gap": torch.mean(
            torch.abs(f_online - f_target)).detach()}

    loss_fn.families = None  # the whole factor tree
    return loss_fn


def make_lcm_distill_loss_v2(
    config: PowerPaintConfig,
    frozen_params: Dict,
    *,
    dtype: torch.dtype = torch.float32,
    huber_c: float = 0.001,
    num_ddim_sections: Optional[int] = None,
) -> Callable:
    """LCM-LoRA distillation of the v2 BrushNet stack: the LoRA student
    sits on the BASE UNet; the BrushNet branch (and both text encoders)
    stay frozen and feed taps to teacher and student alike. Batch needs
    image_u8/mask_u8/ids/ids_plain/ids_uncond (train/data.py,
    version='ppt-v2')."""
    if config.brushnet is None:
        raise ValueError("make_lcm_distill_loss_v2 needs a ppt-v2 config")
    m = build_stack(config, dtype)
    sched = config.scheduler
    acp = torch.as_tensor(alphas_cumprod(sched), dtype=torch.float32)
    grid_np = coarse_grid(config, num_ddim_sections)
    sf = config.vae.scaling_factor
    ts_scale = sched.timestep_scaling

    def loss_fn(lora_tree, batch, draws):
        dev = draws["eps"].device
        acp_d = acp.to(dev)
        grid = torch.as_tensor(grid_np, device=dev)
        batch = batch_tensors(batch, dev)
        img, hole = images(batch)
        keep = 1.0 - hole
        masked = img * keep
        b, h, w_, _ = img.shape

        z0 = vae_sample(m["vae_encode"], frozen_params["vae"], img,
                        draws["lat"], sf)
        cond_lat = vae_sample(m["vae_encode"], frozen_params["vae"], masked,
                              draws["mlat"], sf)
        keep8 = resize_nearest(keep, h // 8, w_ // 8)
        cond5 = torch.cat([cond_lat, keep8], dim=-1).to(dtype)

        # the full grid incl. the t_prev = 0 boundary anchor (see v1 loss)
        i = draws["i"]
        t = grid[i]
        t_prev = torch.where(i > 0, grid[torch.clamp(i - 1, min=0)],
                             torch.zeros_like(t))
        eps = draws["eps"]
        a = acp_d[t][:, None, None, None]
        x_t = torch.sqrt(a) * z0 + torch.sqrt(1.0 - a) * eps

        with torch.no_grad():
            ctx_task = m["text_encoder_brushnet"](
                frozen_params["text_encoder_brushnet"], batch["ids"].long())
            ctx_plain = m["text_encoder"](frozen_params["text_encoder"],
                                          batch["ids_plain"].long())
            ctx_u = m["text_encoder"](frozen_params["text_encoder"],
                                      batch["ids_uncond"].long())

        def eps_at(params_unet, x, tt, ctx):
            with torch.no_grad():
                down, mid, up = m["brushnet"](
                    frozen_params["brushnet"], x.to(dtype), tt, ctx_task,
                    cond5, conditioning_scale=1.0)
            return m["unet"](params_unet, x.to(dtype), tt, ctx,
                             down_block_add_samples=down,
                             mid_block_add_sample=mid,
                             up_block_add_samples=up).float()

        # teacher CFG + one DDIM grid step
        w = draws["w"][:, None, None, None]
        teacher = frozen_params["unet"]
        with torch.no_grad():
            e_u = eps_at(teacher, x_t, t, ctx_u)
            e_c = eps_at(teacher, x_t, t, ctx_plain)
            x_prev = ddim_solver_step(x_t, e_u + w * (e_c - e_u), acp_d, t,
                                      t_prev)

        student = apply_lora(frozen_params["unet"], lora_tree)

        def f_at(x, tt):
            e = eps_at(student, x, tt, ctx_plain)
            a_t = acp_d[tt][:, None, None, None]
            x0 = (x - torch.sqrt(1.0 - a_t) * e) / torch.sqrt(a_t)
            c_skip, c_out = boundary_scalings(tt, ts_scale)
            return (c_out[:, None, None, None] * x0
                    + c_skip[:, None, None, None] * x)

        f_online = f_at(x_t, t)
        with torch.no_grad():
            f_target = f_at(x_prev, t_prev)
        per = torch.mean(_huber(f_online - f_target, huber_c), dim=(1, 2, 3))
        loss = torch.mean(per)
        return loss, {"loss": loss, "consistency_gap": torch.mean(
            torch.abs(f_online - f_target)).detach()}

    loss_fn.families = None  # the whole factor tree
    return loss_fn


def uncond_ids(tokenizer) -> np.ndarray:
    """(77,) ids of the empty prompt (the teacher's CFG uncond row)."""
    return np.asarray(tokenizer([""])[0])
