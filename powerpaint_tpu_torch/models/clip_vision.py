"""CLIP vision tower (ViT image encoder) and the Stable Diffusion safety
checker (the port of ``powerpaint_tpu/models/clip_vision.py``).

Module and parameter names are transformers' ``CLIPVisionModel`` /
``CLIPVisionModelWithProjection`` and diffusers'
``StableDiffusionSafetyChecker`` (its historical ``pre_layrnorm`` included),
so their state dicts load as they are. Activations are (B, S, C); the patch
embedding takes an NHWC image.

The encoder layer is the text tower's (``models/clip_text.py``) with no
causal mask, as in the JAX package: its attention stays on plain tensor
ops and its LayerNorms, like the tower's pre and post LayerNorm, are the
port's ``LayerNorm``, the ``csrc/layer_norm.cu`` kernel on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from powerpaint_tpu_torch.core.config import CLIPVisionConfig
from powerpaint_tpu_torch.models.clip_text import CLIPEncoder
from powerpaint_tpu_torch.models.layers import Conv2D, LayerNorm


class CLIPVisionEmbeddings(nn.Module):
    """Patch conv (no bias), the class token, learned positions."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        c, p = cfg.hidden_size, cfg.patch_size
        self.patch_embedding = Conv2D(3, c, p, stride=p, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(c))
        n_pos = (cfg.image_size // p) ** 2 + 1
        self.position_embedding = nn.Embedding(n_pos, c)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        x = self.patch_embedding(pixels.to(self.patch_embedding.weight.dtype))
        b, c = x.shape[0], x.shape[-1]
        x = x.reshape(b, -1, c)
        cls = self.class_embedding.to(x.dtype).expand(b, 1, c)
        return torch.cat([cls, x], dim=1) + \
            self.position_embedding.weight[None].to(x.dtype)


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = CLIPVisionEmbeddings(cfg)
        self.pre_layrnorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.encoder = CLIPEncoder(cfg)
        self.post_layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, pixels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(last_hidden_state (B, S, C), pooled: the post-LN class token)."""
        x = self.pre_layrnorm(self.embeddings(pixels))
        no_mask = x.new_zeros(())  # bidirectional
        for layer in self.encoder.layers:
            x = layer(x, no_mask)
        return x, self.post_layernorm(x[:, 0])


class CLIPVisionModel(nn.Module):
    def __init__(self, config: CLIPVisionConfig):
        super().__init__()
        self.config = config
        self.vision_model = CLIPVisionTransformer(config)

    def forward(self, pixels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.vision_model(pixels)


class CLIPVisionModelWithProjection(nn.Module):
    """image_embeds = visual_projection(pooled)."""

    def __init__(self, config: CLIPVisionConfig):
        super().__init__()
        self.config = config
        self.vision_model = CLIPVisionTransformer(config)
        self.visual_projection = nn.Linear(config.hidden_size,
                                           config.projection_dim, bias=False)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        return self.visual_projection(self.vision_model(pixels)[1])


def _cosine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return F.normalize(a, dim=-1, eps=0.0) @ F.normalize(b, dim=-1, eps=0.0).T


class StableDiffusionSafetyChecker(nn.Module):
    """The CLIP tower, its projection, and cosine scores against learned
    concept embeddings: an image is flagged when any concept's score exceeds
    that concept's threshold, which drops by 0.01 for an image near any
    special-care concept. Returns per-image flags (bool)."""

    def __init__(self, config: CLIPVisionConfig, num_concepts: int = 17,
                 num_special: int = 3):
        super().__init__()
        self.config = config
        d = config.projection_dim
        self.vision_model = CLIPVisionModel(config)
        self.visual_projection = nn.Linear(config.hidden_size, d, bias=False)
        self.concept_embeds = nn.Parameter(torch.zeros(num_concepts, d))
        self.special_care_embeds = nn.Parameter(torch.zeros(num_special, d))
        self.concept_embeds_weights = nn.Parameter(torch.zeros(num_concepts))
        self.special_care_embeds_weights = nn.Parameter(torch.zeros(num_special))

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        pooled = self.vision_model(pixels)[1]
        emb = self.visual_projection(pooled).float()
        special = _cosine(emb, self.special_care_embeds.float()) - \
            self.special_care_embeds_weights.float()
        adjustment = torch.where((special > 0).any(dim=-1), 0.01, 0.0)
        concept = (_cosine(emb, self.concept_embeds.float())
                   - self.concept_embeds_weights.float() + adjustment[:, None])
        return (concept > 0).any(dim=-1)
