"""FreeU (Si et al. 2023), the free quality knob on the UNet's up blocks.

The port of ``powerpaint_tpu/ops/freeu.py``: in the first two up blocks,
the backbone feature's first half of channels is scaled by b1 / b2 and the
skip connection's lowest frequencies by s1 / s2, before they are
concatenated. The JAX package filters in Fourier space with ``jnp.fft``
(XLA), not a Pallas kernel; here ``torch.fft`` (cuFFT on the card), in
fp32, returning the input's dtype.

The filter transforms over the whole map, so under the row context of
sequence parallelism (``parallel.sequence``) each rank gathers the skip's
rows (up blocks 0 and 1, the two smallest maps), filters the whole map
and keeps its own rows, as GSPMD does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from powerpaint_tpu_torch.parallel import sequence


class FreeUConfig(NamedTuple):
    b1: float = 1.5
    b2: float = 1.6
    s1: float = 0.9
    s2: float = 0.2


def fourier_filter(x: torch.Tensor, threshold: int, scale: float) -> torch.Tensor:
    """Scale the low-frequency components of (B, H, W, C) ``x`` (those
    within ``threshold`` of the centre of the shifted spectrum, in both
    axes) by ``scale``."""
    xf = torch.fft.fftshift(torch.fft.fftn(x.float(), dim=(1, 2)), dim=(1, 2))
    _, h, w, _ = x.shape
    yy = (torch.arange(h, device=x.device) - h // 2).abs()[:, None]
    xx = (torch.arange(w, device=x.device) - w // 2).abs()[None, :]
    mask = torch.where((yy < threshold) & (xx < threshold), scale, 1.0)
    xf = torch.fft.ifftshift(xf * mask[None, :, :, None], dim=(1, 2))
    return torch.fft.ifftn(xf, dim=(1, 2)).real.to(x.dtype)


def apply_freeu(resolution_idx: int, hidden: torch.Tensor, skip: torch.Tensor,
                cfg: Optional[FreeUConfig]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hidden, skip) of up block ``resolution_idx`` with FreeU applied: at
    indices 0 and 1 only, as diffusers' ``apply_freeu``. The backbone
    factor is rounded to the feature's dtype first, as the JAX package's
    weakly typed scalar is."""
    if cfg is None or resolution_idx > 1:
        return hidden, skip
    b, s = (cfg.b1, cfg.s1) if resolution_idx == 0 else (cfg.b2, cfg.s2)
    n = hidden.shape[-1] // 2
    factor = torch.full((), b, dtype=hidden.dtype, device=hidden.device)
    hidden = torch.cat([hidden[..., :n] * factor, hidden[..., n:]], dim=-1)
    rows = sequence.current()
    if rows is None:
        return hidden, fourier_filter(skip, threshold=1, scale=s)
    whole = rows.comm.all_gather(skip, 1)
    filtered = fourier_filter(whole, threshold=1, scale=s)
    return hidden, sequence.share_rows(filtered, rows.comm).contiguous()
