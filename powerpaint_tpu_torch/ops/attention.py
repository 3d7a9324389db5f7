"""Attention dispatch, layout (batch, seq, heads, head_dim).

Every call goes through ``flash_attention``: the CUDA kernel for a CUDA
tensor (self-attention at any length and cross-attention at kv = 77 alike),
its plain PyTorch version for a CPU tensor. No shape gate and no fallback:
a kernel that refuses a CUDA input raises.

Under the row context of sequence parallelism (``parallel.sequence``, the
JAX package's ``ring_context``), a self-attention (the caller says so:
local lengths can equal the text's 77 tokens or an image adapter's) whose
whole sequence is at least the context's ``min_seq`` tokens rides the ring
(``ops.ring_attention``); a shorter one gathers K and V over the data
group and runs one launch on this rank's queries, the function GSPMD
computes there. Cross-attention is unchanged.
"""

from __future__ import annotations

from typing import Optional

import torch

from powerpaint_tpu_torch.ops.flash_attention import flash_attention
from powerpaint_tpu_torch.ops.ring_attention import ring_self_attention
from powerpaint_tpu_torch.parallel import sequence


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              scale: Optional[float] = None,
              self_attention: bool = False) -> torch.Tensor:
    """q: (B, Sq, N, D); k, v: (B, Skv, N, D) -> (B, Sq, N, D).
    ``self_attention``: q, k and v come from the same tokens (under a row
    context, this rank's rows of the canvas)."""
    rows = sequence.current()
    if rows is None or not self_attention:
        return flash_attention(q, k, v, scale=scale)
    if q.shape[1] * rows.size >= rows.min_seq:
        return ring_self_attention(q, k, v, rows.comm, scale=scale)
    kv = rows.comm.all_gather(torch.stack([k, v]), 2)
    return flash_attention(q, kv[0], kv[1], scale=scale)
