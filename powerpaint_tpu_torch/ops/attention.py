"""Attention dispatch, layout (batch, seq, heads, head_dim).

Every call goes through ``flash_attention``: the CUDA kernel for a CUDA
tensor (self-attention at any length and cross-attention at kv = 77 alike),
its plain PyTorch version for a CPU tensor. No shape gate and no fallback:
a kernel that refuses a CUDA input raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from powerpaint_tpu_torch.ops.flash_attention import flash_attention


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, N, D); k, v: (B, Skv, N, D) -> (B, Sq, N, D)."""
    return flash_attention(q, k, v, scale=scale)
