"""Denoising training losses (v1 inpainting UNet, v2 BrushNet branch): the
JAX package's ``train/loss.py``.

Standard epsilon-prediction diffusion objective on the same model inputs
the inference pipelines build (pipelines/inpaint.py / brushnet.py):

    L = E_{t ~ U[0,T), eps ~ N} || eps_hat(x_t, t, cond) - eps ||^2
    x_t = sqrt(acp_t) z0 + sqrt(1 - acp_t) eps

v1: the UNet sees concat(x_t, mask/8, vae(masked image)), 9 channels, and
the task-token text embedding (the PowerPaint recipe trains the task rows
jointly, arXiv 2312.03594 §4).

v2: the frozen base UNet consumes the trainable BrushNet branch's 28 taps;
gradients flow through the base into the branch.

The VAE is always frozen: it encodes under ``torch.no_grad()`` (the JAX
package's ``stop_gradient``). Min-SNR-gamma weighting (arXiv 2303.09556)
via ``snr_gamma``.

A loss is ``loss_fn(params, batch, draws) -> (loss, metrics)``. ``params``
is the stack's fp32 state, ``{family: {name: tensor}}`` (the port's state
dicts, ``io.weights.init_state``'s families); linear and conv parameters
are cast to the compute ``dtype`` where they are used
(``models.layers.cast_for_compute``). ``batch`` is a ``train.data.batches``
dict. ``draws`` holds every random number of the step, explicitly (the
JAX package draws them from its key inside the loss, and threefry cannot
be matched): ``lat`` and ``mlat`` (the two latent samples' normals), ``t``
(B,) and ``eps``; ``draw`` makes them from a ``torch.Generator``.
``loss_fn.families`` names the families it differentiates, and
``loss_fn.models`` holds its modules (``{family: module}``, on the meta
device), which ``train.step.replicate_state(tensor_parallel=True)`` splits.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from powerpaint_tpu_torch.core.config import PowerPaintConfig
from powerpaint_tpu_torch.io.weights import build_models
from powerpaint_tpu_torch.models.layers import cast_for_compute, compute_names
from powerpaint_tpu_torch.schedulers.common import alphas_cumprod


class Module:
    """A module of the stack run on given parameters, its linear and conv
    ones cast to ``dtype`` at use; ``method`` another method than
    ``forward`` (the VAE's ``encode``)."""

    def __init__(self, model: nn.Module, dtype: torch.dtype,
                 method: str = "forward"):
        self.model = _Method(model, method)
        self.dtype = dtype
        self.names = compute_names(model)

    def __call__(self, params: Dict[str, torch.Tensor], *args, **kwargs):
        cast = cast_for_compute(params, self.names, self.dtype)
        return functional_call(self.model, {"m." + k: v for k, v in cast.items()},
                               args, kwargs, strict=True)


class _Method(nn.Module):
    def __init__(self, model: nn.Module, method: str):
        super().__init__()
        self.m = model
        self.method = method

    def forward(self, *args, **kwargs):
        return getattr(self.m, self.method)(*args, **kwargs)


def batch_tensors(batch, device):
    """The batch's arrays as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in batch.items()}


def images(batch) -> tuple:
    """(image in [-1, 1], hole mask 0/1) in fp32, as the JAX losses."""
    img = batch["image_u8"].float() / 127.5 - 1.0
    hole = (batch["mask_u8"] >= 128).float()
    return img, hole


def resize_nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``jax.image.resize(x, (B, h, w, C), "nearest")`` of NHWC ``x``: the
    source index ``floor((i + 0.5) * in / out)`` in fp32, as JAX computes
    it."""
    def index(n_in, n_out):
        pos = (torch.arange(n_out, dtype=torch.float32) + 0.5) * n_in / n_out
        return torch.floor(pos).long().to(x.device)
    return x[:, index(x.shape[1], h)][:, :, index(x.shape[2], w)]


def vae_sample(encode: Module, params, images_: torch.Tensor,
               noise: torch.Tensor, scaling: float) -> torch.Tensor:
    """One scaled latent sample of the frozen VAE, with no gradient."""
    with torch.no_grad():
        mean, logvar = encode(params, images_)
        std = torch.exp(0.5 * logvar.float())
        return (mean.float() + std * noise) * scaling


def weight(acp_t: torch.Tensor, snr_gamma: Optional[float]) -> torch.Tensor:
    """The min-SNR-gamma loss weight of each sample (ones without)."""
    if snr_gamma is None:
        return torch.ones_like(acp_t)
    snr = acp_t / (1.0 - acp_t)
    return torch.minimum(snr, torch.full_like(snr, snr_gamma)) / snr


def latent_shape(config: PowerPaintConfig, batch) -> tuple:
    b, h, w, _ = np.shape(batch["image_u8"])
    return (b, h // 8, w // 8, config.vae.latent_channels)


def draw(config: PowerPaintConfig, batch, generator: torch.Generator,
         names: Sequence[str] = ("lat", "mlat", "t", "eps")) -> dict:
    """The draws of one step from ``generator`` (on its device): normals of
    the latent's shape, t uniform in [0, T)."""
    shape = latent_shape(config, batch)
    dev = generator.device
    out = {}
    for n in names:
        if n == "t":
            out[n] = torch.randint(0, config.scheduler.num_train_timesteps,
                                   (shape[0],), generator=generator, device=dev)
        else:
            out[n] = torch.randn(shape, generator=generator, device=dev)
    return out


def build_stack(config: PowerPaintConfig, dtype: torch.dtype) -> dict:
    """Every family of ``config`` as a ``Module`` (on the meta device: the
    parameters come with each call), and the VAE's encode."""
    models = build_models(config)
    out = {k: Module(m, dtype) for k, m in models.items()}
    out["vae_encode"] = Module(models["vae"], dtype, "encode")
    return out


def stack_models(stack: dict) -> Dict[str, nn.Module]:
    """The modules of a ``build_stack``, by family."""
    return {k: w.model.m for k, w in stack.items() if k != "vae_encode"}


def make_v1_loss(config: PowerPaintConfig, *,
                 dtype: torch.dtype = torch.float32,
                 snr_gamma: Optional[float] = None) -> Callable:
    """loss(params, batch, draws) -> (scalar, metrics) for the 9-channel v1
    stack. ``params`` needs unet/vae/text_encoder; batch needs
    image_u8/mask_u8/ids (train/data.py)."""
    m = build_stack(config, dtype)
    acp = torch.as_tensor(alphas_cumprod(config.scheduler), dtype=torch.float32)
    sf = config.vae.scaling_factor

    def loss_fn(params, batch, draws) -> tuple:
        dev = draws["eps"].device
        batch = batch_tensors(batch, dev)
        img, mask = images(batch)
        masked = img * (1.0 - mask)
        b, h, w, _ = img.shape

        z0 = vae_sample(m["vae_encode"], params["vae"], img, draws["lat"], sf)
        mlat = vae_sample(m["vae_encode"], params["vae"], masked,
                          draws["mlat"], sf)
        mask8 = resize_nearest(mask, h // 8, w // 8)

        t, eps = draws["t"], draws["eps"]
        a = acp.to(dev)[t][:, None, None, None]
        x_t = torch.sqrt(a) * z0 + torch.sqrt(1.0 - a) * eps

        ctx = m["text_encoder"](params["text_encoder"], batch["ids"].long())
        sample = torch.cat([x_t, mask8, mlat], dim=-1).to(dtype)
        eps_hat = m["unet"](params["unet"], sample, t, ctx).float()

        per = torch.mean((eps_hat - eps) ** 2, dim=(1, 2, 3))
        loss = torch.mean(weight(acp.to(dev)[t], snr_gamma) * per)
        return loss, {"loss": loss, "mse": torch.mean(per)}

    loss_fn.families = ("unet", "text_encoder")
    loss_fn.models = stack_models(m)
    return loss_fn


def make_v2_loss(config: PowerPaintConfig, *,
                 dtype: torch.dtype = torch.float32,
                 snr_gamma: Optional[float] = None) -> Callable:
    """v2 BrushNet-branch objective: trainable branch taps injected into
    the (frozen) base UNet; batch needs image_u8/mask_u8/ids/ids_plain."""
    if config.brushnet is None:
        raise ValueError("make_v2_loss needs a ppt-v2 config (a brushnet)")
    m = build_stack(config, dtype)
    acp = torch.as_tensor(alphas_cumprod(config.scheduler), dtype=torch.float32)
    sf = config.vae.scaling_factor

    def loss_fn(params, batch, draws) -> tuple:
        dev = draws["eps"].device
        batch = batch_tensors(batch, dev)
        img, hole = images(batch)
        keep = 1.0 - hole
        masked = img * keep
        b, h, w, _ = img.shape

        z0 = vae_sample(m["vae_encode"], params["vae"], img, draws["lat"], sf)
        cond_lat = vae_sample(m["vae_encode"], params["vae"], masked,
                              draws["mlat"], sf)
        # 5-ch conditioning: the mask channel is 1.0 on PRESERVED pixels
        keep8 = resize_nearest(keep, h // 8, w // 8)
        cond5 = torch.cat([cond_lat, keep8], dim=-1)

        t, eps = draws["t"], draws["eps"]
        a = acp.to(dev)[t][:, None, None, None]
        x_t = (torch.sqrt(a) * z0 + torch.sqrt(1.0 - a) * eps).to(dtype)

        ctx_task = m["text_encoder_brushnet"](params["text_encoder_brushnet"],
                                              batch["ids"].long())
        ctx_plain = m["text_encoder"](params["text_encoder"],
                                      batch["ids_plain"].long())
        down, mid, up = m["brushnet"](params["brushnet"], x_t, t, ctx_task,
                                      cond5.to(dtype), conditioning_scale=1.0)
        eps_hat = m["unet"](params["unet"], x_t, t, ctx_plain,
                            down_block_add_samples=down,
                            mid_block_add_sample=mid,
                            up_block_add_samples=up).float()

        per = torch.mean((eps_hat - eps) ** 2, dim=(1, 2, 3))
        loss = torch.mean(weight(acp.to(dev)[t], snr_gamma) * per)
        return loss, {"loss": loss, "mse": torch.mean(per)}

    loss_fn.families = ("unet", "text_encoder", "brushnet",
                        "text_encoder_brushnet")
    loss_fn.models = stack_models(m)
    return loss_fn


def make_lora_loss(base_loss: Callable, frozen_params: Dict,
                   *, scale: float = 1.0, target: str = "unet") -> Callable:
    """Wrap a loss so the OPTIMIZED tree is a LoRA factor tree: the merged
    weights are rebuilt in every call (``train.lora.apply_lora``, in fp32),
    so gradients flow only into the factors."""
    from powerpaint_tpu_torch.train.lora import apply_lora

    def loss_fn(lora_tree, batch, draws):
        merged = dict(frozen_params)
        merged[target] = apply_lora(frozen_params[target], lora_tree,
                                    scale=scale)
        return base_loss(merged, batch, draws)

    loss_fn.families = None  # the whole factor tree
    return loss_fn

