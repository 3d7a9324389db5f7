"""The plain reference of the served models: the SD1.5 CLIP text tower (with
PowerPaint's task-token rows), the conditional UNet, the BrushNet branch
and the AutoencoderKL, written in plain ``torch`` operations on NCHW
tensors in float32.

It follows the published models (diffusers ``UNet2DConditionModel``,
``AutoencoderKL``, BrushNet's ``BrushNetModel``; transformers
``CLIPTextModel``) and uses their parameter names, so one state dict made
by the benchmark loads into it and into the system under test alike. It
imports nothing of the system under test: no kernel, no plain version of a
kernel, no helper.

Departures from the published code, each one the served system's
convention too: the BrushNet taps are injected as the PowerPaint v2 UNet
does (the first down tap after ``conv_in``'s skip is recorded, then one
after each (resnet, attention) pair and downsampler, each before its skip
is recorded; one after the mid block; one after each up pair and
upsampler); the CLIP causal mask is -1e9 rather than -inf.

Attention is computed as softmax(q k^T / sqrt(d)) v in float32 in blocks
of queries, so that a 96 x 96 latent's self-attention fits in memory.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

TASK_TOKENS = ("P_ctxt", "P_shape", "P_obj")
ATTENTION_BLOCK_BYTES = 1 << 30


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              heads: int) -> torch.Tensor:
    """q (B, Sq, C), k / v (B, Skv, C) -> (B, Sq, C), ``heads`` heads of
    C / heads, in blocks of queries."""
    b, sq, c = q.shape
    skv = k.shape[1]
    d = c // heads
    q = q.reshape(b, sq, heads, d).transpose(1, 2)
    k = k.reshape(b, skv, heads, d).transpose(1, 2)
    v = v.reshape(b, skv, heads, d).transpose(1, 2)
    rows = max(1, ATTENTION_BLOCK_BYTES // (4 * b * heads * skv))
    out = []
    for s in range(0, sq, rows):
        scores = torch.matmul(q[:, :, s:s + rows], k.transpose(-1, -2)) / math.sqrt(d)
        out.append(torch.matmul(torch.softmax(scores, dim=-1), v))
    return torch.cat(out, dim=2).transpose(1, 2).reshape(b, sq, c)


def timestep_features(t: torch.Tensor, dim: int, flip_sin_to_cos: bool,
                      shift: float) -> torch.Tensor:
    """diffusers ``get_timestep_embedding`` of (B,) timesteps, float32."""
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                 device=t.device) / (half - shift)
    emb = t.float()[:, None] * torch.exp(exponent)[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    return emb


class GroupNorm(nn.GroupNorm):
    def forward(self, x, silu: bool = False):
        y = F.group_norm(x, self.num_groups, self.weight, self.bias, self.eps)
        return F.silu(y) if silu else y


class Resnet(nn.Module):
    def __init__(self, cin: int, cout: int, temb: Optional[int], eps: float,
                 groups: int):
        super().__init__()
        self.norm1 = GroupNorm(groups, cin, eps)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb, cout) if temb else None
        self.norm2 = GroupNorm(groups, cout, eps)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb=None):
        h = self.conv1(self.norm1(x, silu=True))
        if self.time_emb_proj is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h, silu=True))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: Optional[int] = None):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(context_dim or dim, dim, bias=False)
        self.to_v = nn.Linear(context_dim or dim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])

    def forward(self, x, context=None):
        ctx = x if context is None else context
        out = attention(self.to_q(x), self.to_k(ctx), self.to_v(ctx), self.heads)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * inner)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, 4 * dim), nn.Identity(),
                                  nn.Linear(4 * dim, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = Attention(dim, heads, context_dim)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """GroupNorm (32 groups, eps 1e-6) -> 1x1 proj_in -> block -> 1x1
    proj_out, plus the residual."""

    def __init__(self, channels: int, heads: int, context_dim: int, layers: int):
        super().__init__()
        self.norm = GroupNorm(32, channels, 1e-6)
        self.proj_in = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList([
            TransformerBlock(channels, heads, context_dim) for _ in range(layers)])
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x, context):
        b, c, h, w = x.shape
        y = self.proj_in(self.norm(x)).flatten(2).transpose(1, 2)
        for blk in self.transformer_blocks:
            y = blk(y, context)
        return self.proj_out(y.transpose(1, 2).reshape(b, c, h, w)) + x


class Down(nn.Module):
    def __init__(self, cin, cout, temb, layers, downsample, cross, u):
        super().__init__()
        eps, g = u["norm_eps"], u["norm_num_groups"]
        self.resnets = nn.ModuleList([Resnet(cin if i == 0 else cout, cout, temb,
                                             eps, g) for i in range(layers)])
        self.attentions = (nn.ModuleList([
            Transformer2D(cout, u["attention_head_dim"], u["cross_attention_dim"],
                          u["transformer_layers_per_block"])
            for _ in range(layers)]) if cross else None)
        self.downsamplers = (nn.ModuleList([Downsample(cout)]) if downsample
                             else None)

    def forward(self, x, temb, context, taps=None):
        skips = []
        for i, resnet in enumerate(self.resnets):
            x = resnet(x, temb)
            if self.attentions is not None:
                x = self.attentions[i](x, context)
            if taps is not None:
                x = x + taps.pop(0)
            skips.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            if taps is not None:
                x = x + taps.pop(0)
            skips.append(x)
        return x, skips


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x, size=None):
        size = size or (2 * x.shape[2], 2 * x.shape[3])
        return self.conv(F.interpolate(x, size=size, mode="nearest-exact"))


class Mid(nn.Module):
    def __init__(self, ch, temb, u):
        super().__init__()
        eps, g = u["norm_eps"], u["norm_num_groups"]
        self.resnets = nn.ModuleList([Resnet(ch, ch, temb, eps, g) for _ in range(2)])
        self.attentions = nn.ModuleList([Transformer2D(
            ch, u["attention_head_dim"], u["cross_attention_dim"],
            u["transformer_layers_per_block"])])

    def forward(self, x, temb, context):
        x = self.resnets[0](x, temb)
        return self.resnets[1](self.attentions[0](x, context), temb)


class Up(nn.Module):
    def __init__(self, prev, cout, skip_in, temb, layers, upsample, cross, u):
        super().__init__()
        eps, g = u["norm_eps"], u["norm_num_groups"]
        self.resnets = nn.ModuleList([
            Resnet((prev if i == 0 else cout) + (skip_in if i == layers - 1 else cout),
                   cout, temb, eps, g) for i in range(layers)])
        self.attentions = (nn.ModuleList([
            Transformer2D(cout, u["attention_head_dim"], u["cross_attention_dim"],
                          u["transformer_layers_per_block"])
            for _ in range(layers)]) if cross else None)
        self.upsamplers = nn.ModuleList([Upsample(cout)]) if upsample else None

    def forward(self, x, temb, skips, context, size, taps=None, emit=None):
        for i, resnet in enumerate(self.resnets):
            x = resnet(torch.cat([x, skips.pop()], dim=1), temb)
            if self.attentions is not None:
                x = self.attentions[i](x, context)
            if emit is not None:
                emit.append(x)
            if taps is not None:
                x = x + taps.pop(0)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x, size)
            if emit is not None:
                emit.append(x)
            if taps is not None:
                x = x + taps.pop(0)
        return x


class TimestepEmbedding(nn.Module):
    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(cin, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


def _blocks(model: nn.Module, u: dict) -> None:
    """The time embedding, down, mid and up blocks of the UNet config
    ``u``: what the UNet and the BrushNet branch share."""
    ch = list(u["block_out_channels"])
    temb = 4 * ch[0]
    n = len(ch)
    model.time_embedding = TimestepEmbedding(ch[0], temb)
    model.down_blocks = nn.ModuleList([
        Down(ch[max(i - 1, 0)], ch[i], temb, u["layers_per_block"], i < n - 1,
             kind.startswith("CrossAttn"), u)
        for i, kind in enumerate(u["down_block_types"])])
    model.mid_block = Mid(ch[-1], temb, u)
    rev = ch[::-1]
    model.up_blocks = nn.ModuleList([
        Up(rev[max(i - 1, 0)], rev[i], rev[min(i + 1, n - 1)], temb,
           u["layers_per_block"] + 1, i < n - 1, kind.startswith("CrossAttn"), u)
        for i, kind in enumerate(u["up_block_types"])])


def _temb(model, u: dict, t: torch.Tensor, batch: int) -> torch.Tensor:
    t = t.reshape(-1).expand(batch)
    return model.time_embedding(timestep_features(
        t, u["block_out_channels"][0], u["flip_sin_to_cos"], u["freq_shift"]))


def _up_counts(u: dict) -> List[int]:
    n = len(u["up_block_types"])
    return [u["layers_per_block"] + 1 + (i < n - 1) for i in range(n)]


def _down_counts(u: dict) -> List[int]:
    n = len(u["down_block_types"])
    return [u["layers_per_block"] + (i < n - 1) for i in range(n)]


class UNet(nn.Module):
    def __init__(self, u: dict):
        super().__init__()
        self.u = u
        ch = u["block_out_channels"]
        self.conv_in = nn.Conv2d(u["in_channels"], ch[0], 3, padding=1)
        _blocks(self, u)
        self.conv_norm_out = GroupNorm(u["norm_num_groups"], ch[0], u["norm_eps"])
        self.conv_out = nn.Conv2d(ch[0], u["out_channels"], 3, padding=1)

    def forward(self, x, t, context, taps=None):
        """x (B, C, h, w), t () timestep, context (B, 77, D); ``taps``
        (down, mid, up) of the BrushNet branch."""
        temb = _temb(self, self.u, t, x.shape[0])
        down_taps, mid_tap, up_taps = ((list(taps[0]), taps[1], list(taps[2]))
                                       if taps is not None else (None, None, None))
        x = self.conv_in(x)
        skips = [x]
        if down_taps is not None:
            x = x + down_taps.pop(0)
        for block in self.down_blocks:
            x, block_skips = block(x, temb, context, down_taps)
            skips.extend(block_skips)
        x = self.mid_block(x, temb, context)
        if mid_tap is not None:
            x = x + mid_tap
        for block in self.up_blocks:
            k = len(block.resnets)
            block_skips, skips = skips[-k:], skips[:-k]
            size = tuple(skips[-1].shape[2:]) if skips else None
            x = block(x, temb, block_skips, context, size, up_taps)
        return self.conv_out(self.conv_norm_out(x, silu=True))


class BrushNet(nn.Module):
    """The PowerPaint v2 branch: the UNet's down, mid and up blocks on
    concat(noisy latent, 5 conditioning channels), with one 1x1 conv on each
    of its 28 features."""

    def __init__(self, u: dict, conditioning_channels: int):
        super().__init__()
        self.u = u
        ch = list(u["block_out_channels"])
        self.conv_in_condition = nn.Conv2d(u["in_channels"] + conditioning_channels,
                                           ch[0], 3, padding=1)
        _blocks(self, u)
        down_ch = [ch[0]]
        for i, c in enumerate(ch):
            down_ch += [c] * u["layers_per_block"] + ([c] if i < len(ch) - 1 else [])
        up_ch = []
        for i, c in enumerate(ch[::-1]):
            up_ch += [c] * (u["layers_per_block"] + 1) + ([c] if i < len(ch) - 1 else [])
        self.brushnet_down_blocks = nn.ModuleList([nn.Conv2d(c, c, 1) for c in down_ch])
        self.brushnet_mid_block = nn.Conv2d(ch[-1], ch[-1], 1)
        self.brushnet_up_blocks = nn.ModuleList([nn.Conv2d(c, c, 1) for c in up_ch])

    def forward(self, x, t, context, cond, scale: float = 1.0):
        temb = _temb(self, self.u, t, x.shape[0])
        x = self.conv_in_condition(torch.cat([x, cond], dim=1))
        down = [x]
        for block in self.down_blocks:
            x, feats = block(x, temb, context)
            down.extend(feats)
        x = self.mid_block(x, temb, context)
        mid = x
        skips, up = list(down), []
        for block in self.up_blocks:
            k = len(block.resnets)
            block_skips, skips = skips[-k:], skips[:-k]
            size = tuple(skips[-1].shape[2:]) if skips else None
            x = block(x, temb, block_skips, context, size, emit=up)
        return ([zc(f) * scale for zc, f in zip(self.brushnet_down_blocks, down)],
                self.brushnet_mid_block(mid) * scale,
                [zc(f) * scale for zc, f in zip(self.brushnet_up_blocks, up)])


class VAEAttention(nn.Module):
    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm(groups, channels, 1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).flatten(2).transpose(1, 2)
        out = self.to_out[0](attention(self.to_q(y), self.to_k(y), self.to_v(y), 1))
        return out.transpose(1, 2).reshape(b, c, h, w) + x


class VAEMid(nn.Module):
    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([Resnet(ch, ch, None, 1e-6, groups) for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(ch, groups)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class VAEDownsample(nn.Module):
    """Pad one zero row and column at the bottom and right, then a VALID
    stride-2 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class EncoderBlock(nn.Module):
    def __init__(self, cin, cout, layers, downsample, groups):
        super().__init__()
        self.resnets = nn.ModuleList([Resnet(cin if i == 0 else cout, cout, None,
                                             1e-6, groups) for i in range(layers)])
        self.downsamplers = nn.ModuleList([VAEDownsample(cout)]) if downsample else None

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        return self.downsamplers[0](x) if self.downsamplers is not None else x


class DecoderBlock(nn.Module):
    def __init__(self, cin, cout, layers, upsample, groups):
        super().__init__()
        self.resnets = nn.ModuleList([Resnet(cin if i == 0 else cout, cout, None,
                                             1e-6, groups) for i in range(layers)])
        self.upsamplers = nn.ModuleList([Upsample(cout)]) if upsample else None

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        return self.upsamplers[0](x) if self.upsamplers is not None else x


class Encoder(nn.Module):
    def __init__(self, v: dict):
        super().__init__()
        ch, g, n = v["block_out_channels"], v["norm_num_groups"], len(v["block_out_channels"])
        self.conv_in = nn.Conv2d(v["in_channels"], ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList([
            EncoderBlock(ch[max(i - 1, 0)], ch[i], v["layers_per_block"], i < n - 1, g)
            for i in range(n)])
        self.mid_block = VAEMid(ch[-1], g)
        self.conv_norm_out = GroupNorm(g, ch[-1], 1e-6)
        self.conv_out = nn.Conv2d(ch[-1], 2 * v["latent_channels"], 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        return self.conv_out(self.conv_norm_out(self.mid_block(x), silu=True))


class Decoder(nn.Module):
    def __init__(self, v: dict):
        super().__init__()
        rev, g = list(v["block_out_channels"])[::-1], v["norm_num_groups"]
        n = len(rev)
        self.conv_in = nn.Conv2d(v["latent_channels"], rev[0], 3, padding=1)
        self.mid_block = VAEMid(rev[0], g)
        self.up_blocks = nn.ModuleList([
            DecoderBlock(rev[max(i - 1, 0)], rev[i], v["layers_per_block"] + 1, i < n - 1, g)
            for i in range(n)])
        self.conv_norm_out = GroupNorm(g, rev[-1], 1e-6)
        self.conv_out = nn.Conv2d(rev[-1], v["out_channels"], 3, padding=1)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(self.conv_norm_out(x, silu=True))


class VAE(nn.Module):
    def __init__(self, v: dict):
        super().__init__()
        if v.get("asymmetric"):
            raise ValueError("the reference has no asymmetric decoder")
        lat = v["latent_channels"]
        self.encoder = Encoder(v)
        self.decoder = Decoder(v)
        self.quant_conv = nn.Conv2d(2 * lat, 2 * lat, 1)
        self.post_quant_conv = nn.Conv2d(lat, lat, 1)

    def encode(self, x):
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))


class TaskTokenTable(nn.Module):
    """The base token table ``wrapped`` and one block of rows per task
    token, whose ids follow the base vocabulary in ``TASK_TOKENS`` order."""

    def __init__(self, vocab: int, dim: int, external: int):
        super().__init__()
        self.wrapped = nn.Embedding(vocab, dim)
        self.trainable_embeddings = nn.ParameterDict({
            n: nn.Parameter(torch.zeros(external // len(TASK_TOKENS), dim))
            for n in TASK_TOKENS})

    def forward(self, ids):
        table = torch.cat([self.wrapped.weight] + [self.trainable_embeddings[n]
                                                   for n in TASK_TOKENS])
        return F.embedding(ids, table)


class CLIPLayer(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        d = c["hidden_size"]
        self.heads = c["num_attention_heads"]
        self.self_attn = nn.Module()
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self.self_attn, name, nn.Linear(d, d))
        self.layer_norm1 = nn.LayerNorm(d, eps=c["layer_norm_eps"])
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(d, c["intermediate_size"])
        self.mlp.fc2 = nn.Linear(c["intermediate_size"], d)
        self.layer_norm2 = nn.LayerNorm(d, eps=c["layer_norm_eps"])

    def forward(self, x, mask):
        a = self.self_attn
        h = self.layer_norm1(x)
        b, s, d = h.shape
        n = self.heads
        q, k, v = (p(h).reshape(b, s, n, d // n).transpose(1, 2)
                   for p in (a.q_proj, a.k_proj, a.v_proj))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d // n) + mask
        h = torch.matmul(torch.softmax(scores, dim=-1), v)
        x = x + a.out_proj(h.transpose(1, 2).reshape(b, s, d))
        h = self.mlp.fc1(self.layer_norm2(x))
        h = h * torch.sigmoid(1.702 * h)  # quick_gelu
        return x + self.mlp.fc2(h)


class CLIPText(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        d = c["hidden_size"]
        self.text_model = tm = nn.Module()
        tm.embeddings = nn.Module()
        tm.embeddings.token_embedding = (
            TaskTokenTable(c["vocab_size"], d, c["num_external_tokens"])
            if c["num_external_tokens"] else nn.Embedding(c["vocab_size"], d))
        tm.embeddings.position_embedding = nn.Embedding(c["max_position_embeddings"], d)
        tm.encoder = nn.Module()
        tm.encoder.layers = nn.ModuleList([CLIPLayer(c) for _ in range(c["num_hidden_layers"])])
        tm.final_layer_norm = nn.LayerNorm(d, eps=c["layer_norm_eps"])

    def forward(self, ids):
        tm = self.text_model
        s = ids.shape[1]
        x = tm.embeddings.token_embedding(ids) + tm.embeddings.position_embedding.weight[:s]
        mask = torch.full((s, s), -1e9, device=ids.device).triu(1)
        for layer in tm.encoder.layers:
            x = layer(x, mask)
        return tm.final_layer_norm(x)


def families(config: dict) -> dict:
    """{family: module} of a served configuration, with the system's family
    names: ``unet``, ``vae`` and ``text_encoder`` (ppt-v1), and for ppt-v2
    also ``brushnet`` and ``text_encoder_brushnet`` (the task-token tower),
    ``text_encoder`` then being the plain tower."""
    te = dict(config["text_encoder"])
    out = {"unet": UNet(config["unet"]), "vae": VAE(config["vae"])}
    if config.get("brushnet") is None:
        out["text_encoder"] = CLIPText(te)
        return out
    out["text_encoder"] = CLIPText(dict(te, num_external_tokens=0))
    bn = config["brushnet"]
    out["brushnet"] = BrushNet(bn["base"], bn["conditioning_channels"])
    out["text_encoder_brushnet"] = CLIPText(te)
    return out


def load(module: nn.Module, state: dict, device) -> nn.Module:
    """``module`` (built on the meta device) with ``state``'s values as
    float32 copies on ``device``."""
    sd = {k: v.detach().to(device=device, dtype=torch.float32, copy=True)
          for k, v in state.items()}
    module.load_state_dict(sd, strict=True, assign=True)
    return module.eval().requires_grad_(False)

