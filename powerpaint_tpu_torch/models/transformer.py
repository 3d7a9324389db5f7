"""Spatial transformer (self + cross attention) for the UNet on NHWC
activations (diffusers ``Transformer2DModel`` / ``BasicTransformerBlock``
parameter names). Self- and cross-attention both go through
``ops.attention``, which launches the flash-attention kernel on the card;
self-attention (``context`` None) says so, which under sequence
parallelism puts it on the ring.

IP-Adapter (diffusers ``IPAdapterAttnProcessor``, as the JAX package's
``Attention`` computes it): a cross-attention built with ``ip_adapters``
n > 0 holds n bias-free ``to_k_ip`` / ``to_v_ip`` pairs; each adapter's
image context attends the same queries, and its result, times that
adapter's scale, is added before ``to_out``. Only ``attn2`` of a block
takes an image context.

Tensor parallelism (``parallel.mesh.shard_model``): a split ``Attention``
holds ``num_heads / tp`` heads of q/k/v (and of each ``to_k_ip`` /
``to_v_ip``) and the matching input columns of ``to_out.0``, and a split
``FeedForward`` the same rows of GEGLU's h and gate and the matching
columns of ``net.2``; the module's ``tp`` (a ``parallel.collectives.Comm``,
None when whole) sums the row-parallel partial products over the model
group (``row_parallel_linear``), and its input passes ``copy_to_model``
(whose backward sums the input gradient). A whole module runs exactly as
before."""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from powerpaint_tpu_torch.models.layers import Conv2D, GroupNorm, LayerNorm
from powerpaint_tpu_torch.ops.attention import attention
from powerpaint_tpu_torch.parallel.collectives import (
    copy_to_model,
    row_parallel_linear,
)


ImageContext = Union[torch.Tensor, Sequence[torch.Tensor], None]
Scales = Union[float, Sequence[float]]


class Attention(nn.Module):
    """q/k/v projections without bias, output projection with bias;
    ``ip_adapters`` decoupled image K/V pairs (``to_k_ip.<a>``,
    ``to_v_ip.<a>``) from ``context_dim``."""

    tp = None  # the model group of a tensor-parallel module

    def __init__(self, query_dim: int, num_heads: int, head_dim: int,
                 context_dim: Optional[int] = None, ip_adapters: int = 0):
        super().__init__()
        inner = num_heads * head_dim
        context_dim = context_dim or query_dim
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])
        if ip_adapters:
            self.to_k_ip = nn.ModuleList([
                nn.Linear(context_dim, inner, bias=False)
                for _ in range(ip_adapters)])
            self.to_v_ip = nn.ModuleList([
                nn.Linear(context_dim, inner, bias=False)
                for _ in range(ip_adapters)])

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None,
                ip_context: ImageContext = None,
                ip_scale: Scales = 1.0) -> torch.Tensor:
        """``ip_context``: the projected image tokens (B, T, context_dim),
        or one such tensor per adapter (the first ones of a stack);
        ``ip_scale`` a float or one per adapter."""
        if self.tp is not None:
            x = copy_to_model(x, self.tp)
            if context is not None:
                context = copy_to_model(context, self.tp)
            if ip_context is not None:
                ip_context = [copy_to_model(c, self.tp) for c in (
                    ip_context if isinstance(ip_context, (tuple, list))
                    else [ip_context])]
        ctx = x if context is None else context
        b, s, _ = x.shape
        skv = ctx.shape[1]
        n, d = self.num_heads, self.head_dim
        q = self.to_q(x).view(b, s, n, d)
        k = self.to_k(ctx).view(b, skv, n, d)
        v = self.to_v(ctx).view(b, skv, n, d)
        out = attention(q, k, v, self_attention=context is None)
        if ip_context is not None:
            contexts = (list(ip_context) if isinstance(ip_context, (tuple, list))
                        else [ip_context])
            scales = (ip_scale if isinstance(ip_scale, (tuple, list))
                      else [ip_scale] * len(contexts))
            for a, (ipc, sc) in enumerate(zip(contexts, scales)):
                t = ipc.shape[1]
                k_ip = self.to_k_ip[a](ipc).view(b, t, n, d)
                v_ip = self.to_v_ip[a](ipc).view(b, t, n, d)
                # the scale rounded to the compute dtype, then a product and
                # a sum each rounded, as the JAX package's ``sc * out_ip``
                sc = float(torch.tensor(float(sc)).to(out.dtype))
                out = out + attention(q, k_ip, v_ip) * sc
        if self.tp is not None:
            return row_parallel_linear(self.to_out[0], out.reshape(b, s, n * d),
                                       self.tp)
        return self.to_out[0](out.reshape(b, s, n * d))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)  # exact (erf) gelu


class FeedForward(nn.Module):
    """GEGLU feed-forward; ``net.1`` is the (parameter-free) dropout slot
    of the diffusers module list."""

    tp = None  # the model group of a tensor-parallel module

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([
            GEGLU(dim, dim * mult), nn.Identity(), nn.Linear(dim * mult, dim)
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            h = self.net[0](copy_to_model(x, self.tp))
            return row_parallel_linear(self.net[2], h, self.tp)
        for m in self.net:
            x = m(x)
        return x


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, head_dim: int,
                 context_dim: int, ip_adapters: int = 0):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, num_heads, head_dim)
        self.norm2 = LayerNorm(dim)
        self.attn2 = Attention(dim, num_heads, head_dim, context_dim,
                               ip_adapters)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                ip_context: ImageContext = None,
                ip_scale: Scales = 1.0) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context, ip_context, ip_scale)
        return x + self.ff(self.norm3(x))


class Transformer2DModel(nn.Module):
    """GroupNorm -> 1x1 proj_in -> transformer blocks -> 1x1 proj_out,
    plus the residual."""

    def __init__(self, channels: int, num_heads: int, head_dim: int,
                 context_dim: int, num_layers: int = 1,
                 use_linear_projection: bool = False, ip_adapters: int = 0):
        super().__init__()
        inner = num_heads * head_dim
        self.use_linear_projection = use_linear_projection
        self.norm = GroupNorm(32, channels, 1e-6)
        if use_linear_projection:
            self.proj_in = nn.Linear(channels, inner)
            self.proj_out = nn.Linear(inner, channels)
        else:
            self.proj_in = Conv2D(channels, inner, 1)
            self.proj_out = Conv2D(inner, channels, 1)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, num_heads, head_dim, context_dim,
                                  ip_adapters)
            for _ in range(num_layers)
        ])

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                ip_context: ImageContext = None,
                ip_scale: Scales = 1.0) -> torch.Tensor:
        b, h, w, c = x.shape
        y = self.proj_in(self.norm(x))  # NHWC, 1x1 conv or linear alike
        y = y.reshape(b, h * w, y.shape[-1])
        for blk in self.transformer_blocks:
            y = blk(y, context, ip_context, ip_scale)
        y = self.proj_out(y.reshape(b, h, w, y.shape[-1]))
        return y + x
