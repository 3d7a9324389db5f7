"""Spatial transformer (self + cross attention) for the UNet on NHWC
activations (diffusers ``Transformer2DModel`` / ``BasicTransformerBlock``
parameter names). Self- and cross-attention both go through
``ops.attention``, which launches the flash-attention kernel on the card."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from powerpaint_tpu_torch.models.layers import Conv2D, GroupNorm, LayerNorm
from powerpaint_tpu_torch.ops.attention import attention


class Attention(nn.Module):
    """q/k/v projections without bias, output projection with bias."""

    def __init__(self, query_dim: int, num_heads: int, head_dim: int,
                 context_dim: Optional[int] = None):
        super().__init__()
        inner = num_heads * head_dim
        context_dim = context_dim or query_dim
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = x if context is None else context
        b, s, _ = x.shape
        skv = ctx.shape[1]
        n, d = self.num_heads, self.head_dim
        q = self.to_q(x).view(b, s, n, d)
        k = self.to_k(ctx).view(b, skv, n, d)
        v = self.to_v(ctx).view(b, skv, n, d)
        out = attention(q, k, v).reshape(b, s, n * d)
        return self.to_out[0](out)


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

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([
            GEGLU(dim, dim * mult), nn.Identity(), nn.Linear(dim * mult, dim)
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for m in self.net:
            x = m(x)
        return x


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, head_dim: int,
                 context_dim: int):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, num_heads, head_dim)
        self.norm2 = LayerNorm(dim)
        self.attn2 = Attention(dim, num_heads, head_dim, context_dim)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2DModel(nn.Module):
    """GroupNorm -> 1x1 proj_in -> transformer blocks -> 1x1 proj_out,
    plus the residual."""

    def __init__(self, channels: int, num_heads: int, head_dim: int,
                 context_dim: int, num_layers: int = 1,
                 use_linear_projection: bool = False):
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
            BasicTransformerBlock(inner, num_heads, head_dim, context_dim)
            for _ in range(num_layers)
        ])

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        y = self.proj_in(self.norm(x))  # NHWC, 1x1 conv or linear alike
        y = y.reshape(b, h * w, y.shape[-1])
        for blk in self.transformer_blocks:
            y = blk(y, context)
        y = self.proj_out(y.reshape(b, h, w, y.shape[-1]))
        return y + x
