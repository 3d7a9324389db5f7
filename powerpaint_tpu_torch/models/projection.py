"""The IP-Adapter image projection (the port of
``powerpaint_tpu/models/projection.py``; diffusers ``ImageProjection``
names): a linear map of a CLIP image embedding to ``tokens`` context rows
of ``cross_attention_dim``, then LayerNorm (the ``csrc/layer_norm.cu``
kernel on the card)."""

from __future__ import annotations

import torch
from torch import nn

from powerpaint_tpu_torch.models.layers import LayerNorm


class ImageProjection(nn.Module):
    def __init__(self, image_embed_dim: int, cross_attention_dim: int = 768,
                 tokens: int = 4):
        super().__init__()
        self.tokens = tokens
        self.cross_attention_dim = cross_attention_dim
        self.image_embeds = nn.Linear(image_embed_dim,
                                      tokens * cross_attention_dim)
        self.norm = LayerNorm(cross_attention_dim)

    def forward(self, image_embeds: torch.Tensor) -> torch.Tensor:
        """(B, image_embed_dim) -> (B, tokens, cross_attention_dim) in the
        linear's dtype."""
        x = self.image_embeds(image_embeds.to(self.image_embeds.weight.dtype))
        x = x.reshape(x.shape[0], self.tokens, self.cross_attention_dim)
        return self.norm(x)
