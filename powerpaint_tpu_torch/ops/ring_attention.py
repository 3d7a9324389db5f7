"""Ring self-attention over a canvas whose tokens are split over ranks (the
port of ``powerpaint_tpu/ops/ring_attention.py``).

The sequence axis of q, k and v (B, S, N, D) is split over a data group:
each rank holds S / n consecutive tokens. Each rank's q attends every
rank's K/V block in n hops: a hop is one launch of the flash-attention
kernel's log-sum-exp mode (``ops.flash_attention.flash_attention_lse``:
the block's output in fp32 and each query row's log-sum-exp), folded into
an fp32 (out, lse) accumulator by the online softmax of the JAX package's
``_block_attend``:

    lse' = logaddexp(lse, lse_b)
    out' = out * exp(lse - lse') + out_b * exp(lse_b - lse')

and after every hop but the last the K/V block moves one rank round the
ring (``Comm.shift``: index i sends to i + 1, as ``jax.lax.ppermute``).
Exact (the softmax over all keys), not an approximation. The partial
outputs stay in fp32, so the n merges round to the inputs' type once, at
the end. On the CPU the same loop runs with the plain version
(``flash_attention_lse_plain``).
"""

from __future__ import annotations

from typing import Optional

import torch

from powerpaint_tpu_torch.ops.flash_attention import flash_attention_lse


def merge_partial(out: torch.Tensor, lse: torch.Tensor, out_b: torch.Tensor,
                  lse_b: torch.Tensor):
    """Fold one block's (out_b (B, Sq, N, D), lse_b (B, N, Sq)) into the
    running (out, lse): the online softmax over the union of their keys,
    in fp32."""
    new = torch.logaddexp(lse, lse_b)
    w = torch.exp(lse - new).transpose(1, 2)[..., None]
    w_b = torch.exp(lse_b - new).transpose(1, 2)[..., None]
    return out * w + out_b * w_b, new


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        comm, *, scale: Optional[float] = None) -> torch.Tensor:
    """Non-causal self-attention over (B, S, N, D) with the sequence split
    over ``comm`` (a ``parallel.collectives.Comm``, every rank the same
    S / n tokens): this rank's q against every rank's k and v, returned in
    q's dtype, (B, S / n, N, D)."""
    out, lse = flash_attention_lse(q, k, v, scale=scale)
    if comm.size == 1:
        return out.to(q.dtype)
    kv = torch.stack([k, v])
    for _ in range(comm.size - 1):
        kv = comm.shift(kv)
        out_b, lse_b = flash_attention_lse(q, kv[0], kv[1], scale=scale)
        out, lse = merge_partial(out, lse, out_b, lse_b)
    return out.to(q.dtype)
