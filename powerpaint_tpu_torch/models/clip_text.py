"""CLIP text encoder (ViT-L/14 text tower, SD1.5) with the task-token rows.

transformers ``CLIPTextModel`` parameter names. With task tokens, the token
table is PowerPaint's ``EmbeddingLayerWithFixes`` layout:
``token_embedding.wrapped.weight`` plus one
``token_embedding.trainable_embeddings.<name>`` block of rows per placeholder
(P_ctxt, P_shape, P_obj), whose ids follow the base vocabulary in that
order, so the lookup is one gather from the concatenated table.

The causal self-attention stays on plain tensor ops (fp32 logits and
softmax), as the JAX package keeps it on einsum.

Tensor parallelism (``parallel.mesh.shard_model``): a split attention holds
``num_heads / tp`` heads of q/k/v and the matching input columns of
``out_proj``, a split MLP a ``1 / tp`` block of ``fc1``'s rows and of
``fc2``'s columns; ``tp`` (None when whole) sums the partial products.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from powerpaint_tpu_torch.core.config import CLIPTextConfig
from powerpaint_tpu_torch.models.layers import LayerNorm
from powerpaint_tpu_torch.parallel.collectives import (
    copy_to_model,
    row_parallel_linear,
)

TASK_TOKEN_ORDER = ("P_ctxt", "P_shape", "P_obj")


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class TaskTokenEmbedding(nn.Module):
    """Base token table plus named blocks of learned rows: the task tokens'
    (``num_external`` rows split evenly over ``names``), then any a user
    adds (``add_rows``: textual inversion), each block's ids following the
    ones before it, as the tokenizer registers them."""

    def __init__(self, vocab_size: int, dim: int, num_external: int,
                 names: Sequence[str] = TASK_TOKEN_ORDER):
        super().__init__()
        if names and num_external % len(names):
            raise ValueError(f"{num_external} task rows do not split over "
                             f"{len(names)} placeholders")
        self.names = list(names)
        self.wrapped = nn.Embedding(vocab_size, dim)
        rows = num_external // len(names) if names else 0
        self.trainable_embeddings = nn.ParameterDict({
            n: nn.Parameter(torch.zeros(rows, dim)) for n in self.names
        })

    def add_rows(self, name: str, rows: torch.Tensor) -> None:
        """Append a block of rows, ``trainable_embeddings.<name>`` in the
        state dict (the reference's name for an added embedding), in the
        table's dtype and on its device."""
        if "." in name or name in self.trainable_embeddings:
            raise ValueError(f"cannot add a block of rows named {name!r}")
        w = self.wrapped.weight
        self.trainable_embeddings[name] = nn.Parameter(
            rows.to(w.device, w.dtype), requires_grad=False)
        self.names.append(name)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        table = torch.cat([self.wrapped.weight] + [
            self.trainable_embeddings[n] for n in self.names
        ])
        return F.embedding(ids, table)


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        if cfg.num_external_tokens:
            self.token_embedding = TaskTokenEmbedding(
                cfg.vocab_size, cfg.hidden_size, cfg.num_external_tokens)
        else:
            self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings,
                                               cfg.hidden_size)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        s = ids.shape[1]
        return self.token_embedding(ids) + self.position_embedding.weight[None, :s]


class CLIPAttention(nn.Module):
    tp = None  # the model group of a tensor-parallel module

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        c = cfg.hidden_size
        self.num_heads = cfg.num_attention_heads
        self.head_dim = c // cfg.num_attention_heads
        self.q_proj = nn.Linear(c, c)
        self.k_proj = nn.Linear(c, c)
        self.v_proj = nn.Linear(c, c)
        self.out_proj = nn.Linear(c, c)

    def forward(self, x: torch.Tensor, causal_mask: torch.Tensor) -> torch.Tensor:
        b, s, c = x.shape
        n, d = self.num_heads, self.head_dim
        if self.tp is not None:
            x = copy_to_model(x, self.tp)
        q = self.q_proj(x).view(b, s, n, d)
        k = self.k_proj(x).view(b, s, n, d)
        v = self.v_proj(x).view(b, s, n, d)
        logits = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float())
        logits = logits * d ** -0.5 + causal_mask
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bnqk,bknd->bqnd", probs.float(), v.float())
        out = out.to(x.dtype).reshape(b, s, n * d)
        if self.tp is not None:
            return row_parallel_linear(self.out_proj, out, self.tp)
        return self.out_proj(out)


class CLIPMLP(nn.Module):
    tp = None  # the model group of a tensor-parallel module

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.act = quick_gelu if cfg.hidden_act == "quick_gelu" else F.gelu
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            h = self.act(self.fc1(copy_to_model(x, self.tp)))
            return row_parallel_linear(self.fc2, h, self.tp)
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, causal_mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), causal_mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([
            CLIPEncoderLayer(cfg) for _ in range(cfg.num_hidden_layers)
        ])


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = CLIPTextEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)


class CLIPTextModel(nn.Module):
    """Returns last_hidden_state (B, S, H) in the compute dtype."""

    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.config = config
        self.text_model = CLIPTextTransformer(config)

    def add_token_rows(self, name: str, rows: torch.Tensor) -> None:
        """Append a user token's rows (n, D) to the token table; a plain
        table becomes a ``TaskTokenEmbedding`` around it first, with no task
        rows."""
        emb = self.text_model.embeddings
        if isinstance(emb.token_embedding, nn.Embedding):
            table = emb.token_embedding
            with torch.device("meta"):
                wrapper = TaskTokenEmbedding(table.num_embeddings,
                                             table.embedding_dim, 0, names=())
            wrapper.wrapped = table
            emb.token_embedding = wrapper
        emb.token_embedding.add_rows(name, rows)

    def forward(self, input_ids: torch.Tensor, clip_skip: int = 0) -> torch.Tensor:
        """``clip_skip``: stop ``clip_skip`` layers early and apply the final
        LayerNorm there (HF ``hidden_states[-(clip_skip + 1)]`` + final LN)."""
        tm = self.text_model
        dtype = tm.encoder.layers[0].mlp.fc1.weight.dtype
        s = input_ids.shape[1]
        x = tm.embeddings(input_ids).to(dtype)
        causal = torch.full((s, s), -1e9, dtype=torch.float32,
                            device=input_ids.device).triu(1)
        for layer in tm.encoder.layers[:len(tm.encoder.layers) - clip_skip]:
            x = layer(x, causal)
        return tm.final_layer_norm(x)
