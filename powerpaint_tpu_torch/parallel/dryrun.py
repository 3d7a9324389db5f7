"""The port's multi-process dry run: its counterpart of the JAX package's
``dryrun_multichip`` (v1 and v2 over a data x model mesh, and a ZeRO-3 v1
train step, each against the one-process run with the same bounds).

    python -m powerpaint_tpu_torch.parallel.dryrun            # 4 gloo CPU ranks, data 2 x model 2
    python -m powerpaint_tpu_torch.parallel.dryrun --device cuda --ranks 2 --backend gloo

Every check is a function of one rank, which builds its meshes over the
default group (``parallel.mesh.build_mesh``; every rank makes the same
calls), runs the one-process reference on its own device, and returns
plain numbers; the caller holds them to the bounds. The rank functions
live here, in the package, because ``parallel.launch.spawn`` pickles them
by name and its children import their module.

Sequence parallelism (``sp_checks``, ``card_rank``'s part (e)): the ring
attention, the row-split ops and the tiny UNet on each rank's rows of one
canvas, and the three pipelines with ``sequence_parallel=True``, each rank
returning the whole output for its caller to hold to the one-process call
(or, in the tests, to the JAX package).

Bounds (the JAX dry run's, ``__graft_entry__._dryrun_impl``): an image
within 2 uint8 levels of the one-process image; a loss within 1e-4
(relative); after one AdamW step at lr 1e-3, the task-token rows within
2 lr + slack of the one-process rows everywhere (an element whose gradient
is near zero flips its normalised update's sign on a last-ulp difference)
and within 1e-5 + 1e-3 |b| at 99% of the elements.
"""

from __future__ import annotations

import argparse
import copy
import functools
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from powerpaint_tpu_torch.core.config import (
    ppt_v1_config,
    ppt_v1_controlnet_config,
    ppt_v2_config,
)
from powerpaint_tpu_torch.core.validation import InputValidationError
from powerpaint_tpu_torch.io.weights import init_state, load_models
from powerpaint_tpu_torch.models import transformer
from powerpaint_tpu_torch.models.layers import Conv2D
from powerpaint_tpu_torch.models.resnet import Downsample2D
from powerpaint_tpu_torch.models.vae import VAEDownsample2D
from powerpaint_tpu_torch.ops import conv, norms
from powerpaint_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bf16_softmax,
    flash_attention_lse,
)
from powerpaint_tpu_torch.ops.freeu import FreeUConfig
from powerpaint_tpu_torch.ops.ring_attention import ring_self_attention
from powerpaint_tpu_torch.parallel import collectives, sequence
from powerpaint_tpu_torch.parallel.launch import cpu_threads, spawn
from powerpaint_tpu_torch.parallel.mesh import (
    build_mesh,
    choose_backend,
    fsdp_dim,
    local_piece,
    param_spec,
)
from powerpaint_tpu_torch.pipelines.brushnet import BrushNetPipeline
from powerpaint_tpu_torch.pipelines.controlnet import ControlNetPipeline
from powerpaint_tpu_torch.pipelines.inpaint import InpaintPipeline
from powerpaint_tpu_torch.testing import (
    tiny_v1_config,
    tiny_v1_controlnet_config,
    tiny_v2_config,
)
from powerpaint_tpu_torch.text.tokenizer import (
    HashTokenizer,
    TokenizerWrapper,
    add_task_tokens,
)
from powerpaint_tpu_torch.train import data
from powerpaint_tpu_torch.train.cli import channels_last
from powerpaint_tpu_torch.train.loss import draw, make_v1_loss
from powerpaint_tpu_torch.train.step import (
    AdamW,
    flatten,
    fsdp_state,
    gather_state,
    init_train_state,
    make_train_step,
    replicate_state,
    trainable_mask,
)
from powerpaint_tpu_torch.train.trainer import load_train_state, save_train_state

U8_MAX = 2
LOSS_RTOL = 1e-4
LR = 1e-3
STEP_MAX = 2.1e-3  # 2 * LR + slack
EMA_DECAY = 0.999
TIGHT_SHARE = 0.99
TASK_ROWS = ("text_encoder/text_model.embeddings.token_embedding."
             "trainable_embeddings.")


# ---------------------------------------------------------------------------
# stacks and inputs
# ---------------------------------------------------------------------------


def config(kind: str, full: bool = False):
    """ppt-v1 ("v1"), ppt-v2 ("v2") or v1 + ControlNet ("cn"): the tiny
    configs (the JAX sharded tests' widths: blocks (32, 64, 64, 64), two
    heads) or the published ones."""
    if full:
        return {"v1": ppt_v1_config, "v2": ppt_v2_config,
                "cn": ppt_v1_controlnet_config}[kind]()
    return {"v1": tiny_v1_config, "v2": tiny_v2_config,
            "cn": tiny_v1_controlnet_config}[kind]()


def stack(kind: str, device, *, full: bool = False, seed: int = 0,
          dtype: torch.dtype = torch.float32):
    """(config, random state made on ``device`` from ``seed``, tokenizer)."""
    cfg = config(kind, full)
    device = torch.device(device)
    state = init_state(cfg, torch.Generator(device=device).manual_seed(seed),
                       device=device, dtype=dtype)
    return cfg, state, tokenizer(cfg)


def tokenizer(cfg):
    """The hash tokenizer of ``cfg``'s vocabulary with the task tokens."""
    tok = TokenizerWrapper(HashTokenizer(cfg.text_encoder.vocab_size))
    add_task_tokens(tok)
    return tok


def inputs(hw: int, seed: int = 0):
    """A random image and a centred square hole, as the JAX dry run's."""
    rng = np.random.RandomState(seed)
    img = (rng.rand(hw, hw, 3) * 255).astype(np.uint8)
    mask = np.zeros((hw, hw), np.float32)
    mask[hw // 4:3 * hw // 4, hw // 4:3 * hw // 4] = 1.0
    return img, mask


def edges(hw: int, seed: int = 0) -> np.ndarray:
    """A control image: white outlines of random boxes on black."""
    rng = np.random.RandomState(seed)
    e = np.zeros((hw, hw), bool)
    for _ in range(3):
        y0, x0 = rng.randint(0, hw // 2, 2)
        y1, x1 = y0 + rng.randint(2, hw // 2, 2)
        e[y0:y1, x0] = e[y0:y1, x1 - 1] = e[y0, x0:x1] = e[y1 - 1, x0:x1] = True
    return np.repeat(e[..., None], 3, -1).astype(np.uint8) * 255


def pipeline(kind: str, cfg, state, tok, dtype, mesh=None, device=None,
             **kw):
    cls = {"v1": InpaintPipeline, "v2": BrushNetPipeline,
           "cn": ControlNetPipeline}[kind]
    return cls(cfg, state, tok, dtype=dtype, device=device, mesh=mesh, **kw)


def u8_diff(a: np.ndarray, b: np.ndarray) -> dict:
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return {"max": int(d.max()), "mean": float(d.mean()),
            "shape": list(a.shape), "equal": bool(np.array_equal(a, b))}


class AttentionShapes:
    """Records the (heads, head dim) of every attention the transformer
    blocks run while active (the flash kernel's N and D on the card)."""

    def __init__(self):
        self.shapes = set()

    def __enter__(self):
        self._orig = transformer.attention

        def recording(q, k, v, **kw):
            self.shapes.add((int(q.shape[2]), int(q.shape[3])))
            return self._orig(q, k, v, **kw)

        transformer.attention = recording
        return self

    def __exit__(self, *exc):
        transformer.attention = self._orig


def launch_counts() -> Dict[str, int]:
    """Every hand kernel's launch counter (B1-B6, the modes sequence
    parallelism adds, and the bf16-softmax mode, which no rank launches) of
    this process."""
    return {"flash_attention": flash_attention.launches,
            "flash_attention_lse": flash_attention_lse.launches,
            "flash_attention_bf16_softmax": flash_attention_bf16_softmax.launches,
            "group_norm_moments": norms.group_norm_moments.launches,
            "conv3x3_gn_silu": conv.conv3x3_gn_silu.launches,
            "conv3x3": conv.conv3x3.launches,
            "group_norm": norms.group_norm.launches,
            "group_norm_stats": norms.group_norm_stats.launches,
            "gn_silu_quantize_int8": norms.gn_silu_quantize_int8.launches,
            "quantize_int8": norms.quantize_int8.launches,
            "layer_norm": norms.layer_norm.launches,
            "conv3x3_gn_silu_int8": conv.conv3x3_gn_silu_int8.launches,
            "conv3x3_int8": conv.conv3x3_int8.launches}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# inference checks
# ---------------------------------------------------------------------------


def pipeline_check(mesh, kind: str, *, full: bool = False, batch: int,
                   steps: int, hw: int, seed: int = 1,
                   dtype=torch.float32) -> dict:
    """One call of ``kind``'s pipeline over ``mesh`` against the same call
    in this process alone (batch ``batch``, seeds ``seed``, ``seed + 1``,
    ...): the uint8 difference, the mesh call's launches and attention
    shapes on this rank, and whether ``submit()`` of the call gave the
    same images."""
    cfg, state, tok = stack(kind, mesh.device, full=full, dtype=dtype)
    img, mask = inputs(hw)
    kw = dict(prompt="a cat", num_inference_steps=steps, seed=seed,
              num_images_per_prompt=batch)
    if kind == "cn":
        kw["control_image"] = edges(hw)
    ref = pipeline(kind, cfg, state, tok, dtype, device=mesh.device)(
        img, mask, **kw)
    pipe = pipeline(kind, cfg, state, tok, dtype, mesh=mesh)
    before = launch_counts()
    t0 = time.perf_counter()
    with AttentionShapes() as seen:
        out = pipe(img, mask, **kw)
    _sync(mesh.device)
    after = launch_counts()
    seconds = time.perf_counter() - t0
    submitted = pipe.submit(img, mask, **kw).result()
    return dict(u8_diff(out, ref), seconds=seconds,
                launches={k: after[k] - before[k] for k in after},
                attention_shapes=sorted(seen.shapes),
                submit_equal=bool(np.array_equal(submitted, out)))


def random_lora(unet: torch.nn.Module, text: torch.nn.Module, rank: int = 4,
                seed: int = 0) -> dict:
    """A peft-layout LoRA on every split projection of the UNet and the
    text encoder (q/k/v, GEGLU's proj, to_out, ff.net.2, fc1, fc2)."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for prefix, model in (("unet", unet), ("text_encoder", text)):
        for name, p in model.named_parameters():
            if not name.endswith(".weight") or p.dim() != 2 or \
                    param_spec(name) is None:
                continue
            base = name[: -len(".weight")]
            out_f, in_f = p.shape
            sd[f"{prefix}.{base}.lora_A.weight"] = torch.randn(
                rank, in_f, generator=g) * 0.1
            sd[f"{prefix}.{base}.lora_B.weight"] = torch.randn(
                out_f, rank, generator=g) * 0.1
    return sd


def lora_check(mesh, *, steps: int, hw: int, seed: int = 1,
               dtype=torch.float32) -> dict:
    """A LoRA merged into a v1 pipeline over ``mesh`` and the same LoRA on
    the one-process pipeline: the images, and each rank's weights against
    its piece of the one-process weights after the merge, a new scale and
    the unload (bit for bit)."""
    cfg, state, tok = stack("v1", mesh.device, dtype=dtype)
    single = pipeline("v1", cfg, copy.deepcopy(state), tok, dtype,
                      device=mesh.device)
    pipe = pipeline("v1", cfg, copy.deepcopy(state), tok, dtype, mesh=mesh)
    sd = random_lora(single.unet, single.text_encoder)

    def pieces_equal() -> bool:
        ok = True
        for fam in ("unet", "text_encoder"):
            whole = dict(getattr(single, fam).named_modules())
            for name, m in getattr(pipe, fam).named_modules():
                if isinstance(m, torch.nn.Linear):
                    ok &= torch.equal(m.weight,
                                      local_piece(m, whole[name].weight))
        return bool(ok)

    unmatched = (single.load_lora_weights(sd, 0.7),
                 pipe.load_lora_weights(sd, 0.7))
    merged = pieces_equal()
    img, mask = inputs(hw)
    kw = dict(prompt="a cat", num_inference_steps=steps, seed=seed,
              num_images_per_prompt=mesh.data.size)
    diff = u8_diff(pipe(img, mask, **kw), single(img, mask, **kw))
    single.set_lora_scale(0.3)
    pipe.set_lora_scale(0.3)
    rescaled = pieces_equal()
    single.unload_lora_weights()
    pipe.unload_lora_weights()
    return dict(diff, unmatched=[len(u) for u in unmatched], merged=merged,
                rescaled=rescaled, unloaded=pieces_equal())


# ---------------------------------------------------------------------------
# training checks
# ---------------------------------------------------------------------------


def _train_setup(device, *, full: bool, hw: int, batch: int, dtype,
                 seed: int = 0):
    """(config, v1 loss, a maker of fresh fp32 params on ``device``, one
    global batch)."""
    cfg = config("v1", full)
    b = next(data.batches(data.SyntheticSource(hw=hw, seed=21), tokenizer(cfg),
                          batch_size=batch, version="ppt-v1", seed=22))

    def params():
        gen = torch.Generator(device=device).manual_seed(seed)
        return channels_last(init_state(cfg, gen, device=device))

    return cfg, make_v1_loss(cfg, dtype=dtype), params, b


def _one_step(cfg, loss_fn, params, batch, *, place=None, lr: float = LR,
              draw_seed: int = 9, steps: int = 1):
    """One v1 AdamW step (or ``steps``), EMA on, from fresh ``params``
    (placed by ``place(state)`` where given) on the global ``batch``;
    returns (state, the last metrics)."""
    tx = AdamW(lr, labels=trainable_mask(params, "v1"))
    state = init_train_state(params, tx, ema=True)
    if place is not None:
        state = place(state)
    step = make_train_step(loss_fn, tx, ema_decay=EMA_DECAY,
                           draw=functools.partial(draw, cfg))
    metrics = None
    for _ in range(steps):
        state, metrics = step(state, batch, draw_seed)
    return state, metrics


def _leaves(state) -> List[torch.Tensor]:
    """Every tensor of a train state, in a fixed order."""
    return (list(flatten(state.params).values())
            + [t for name in ("mu", "nu") for t in state.opt_state[name].values()]
            + list(state.ema.values()))


def _task_rows(state) -> np.ndarray:
    flat = flatten(state.params)
    return np.concatenate([flat[k].detach().float().cpu().numpy()
                           for k in sorted(flat) if k.startswith(TASK_ROWS)])


def update_diff(a: np.ndarray, b: np.ndarray) -> dict:
    d = np.abs(a - b)
    return {"max": float(d.max()),
            "tight": float(np.mean(d <= 1e-5 + 1e-3 * np.abs(b)))}


def state_bytes(state, n: int, whole: bool = False) -> int:
    """Bytes of the parameters, moments and EMA a rank holds (``whole``:
    would hold unsplit), over the leaves ZeRO-3 splits ``n`` ways."""
    def shape(k, v):
        if state.whole:
            return state.whole[k][0]
        if state.tp_plan and k in state.tp_plan:
            return state.tp_plan[k].whole(v.shape)
        return tuple(v.shape)

    tensors = list(flatten(state.params).items())
    for name in ("mu", "nu", "acc"):
        tensors += list(state.opt_state.get(name, {}).items())
    tensors += list((state.ema or {}).items())
    return int(sum((int(np.prod(shape(k, v))) if whole else v.numel())
                   * v.element_size() for k, v in tensors
                   if fsdp_dim(shape(k, v), n) is not None))


def train_check(mesh, mode: str, *, full: bool = False, hw: int = 32,
                batch: int, dtype=torch.float32,
                reference: Optional[dict] = None,
                checkpoint: Optional[str] = None) -> dict:
    """One v1 step placed on ``mesh`` (``mode``: "dp" replicated, "zero3"
    ``fsdp_state``, "tp" ``replicate_state(tensor_parallel=True)``) against
    ``reference`` (a ``single_step`` result; computed here when None): the
    loss, the task-token rows' update, the bytes this rank holds at rest,
    and (ZeRO-3) the share of a large leaf it holds before and after.
    ``checkpoint``: a path to save the stepped state to (gathered, rank 0
    writes) and load back into a fresh placed state: whether every piece
    came back bit for bit."""
    cfg, loss_fn, params, b = _train_setup(mesh.device, full=full, hw=hw,
                                           batch=batch, dtype=dtype)
    if reference is None:
        reference = single_step(mesh.device, full=full, hw=hw, batch=batch,
                                dtype=dtype)

    def place(state):
        if mode == "zero3":
            return fsdp_state(mesh, state)[0]
        return replicate_state(mesh, state, tensor_parallel=mode == "tp",
                               models=loss_fn.models)

    t0 = time.perf_counter()
    state, metrics = _one_step(cfg, loss_fn, params(), b, place=place)
    _sync(mesh.device)
    seconds = time.perf_counter() - t0
    out = dict(loss=float(metrics["loss"]), ref_loss=reference["loss"],
               grad_norm=float(metrics["grad_norm"]),
               ref_grad_norm=reference["grad_norm"],
               update=update_diff(reference["rows"], _task_rows(state)),
               bytes_at_rest=state_bytes(state, mesh.data.size),
               whole_bytes=state_bytes(state, mesh.data.size, whole=True),
               seconds=seconds, rows=_task_rows(state))
    if checkpoint is not None:
        save_train_state(checkpoint, state)
        dist.barrier()
        fresh = _one_step(cfg, loss_fn, params(), b, place=place, steps=0)[0]
        load_train_state(checkpoint, fresh)
        out["resumed_equal"] = all(
            torch.equal(x, y) for x, y in zip(_leaves(state), _leaves(fresh)))
    if mode == "zero3":
        big = max((k for k, d in state.layout.items() if d is not None),
                  key=lambda k: np.prod(state.whole[k][0]))
        held = flatten(state.params)[big].numel()
        out.update(big_leaf=big, big_share=held / np.prod(state.whole[big][0]),
                   layout_kept=all(
                       flatten(state.params)[k].shape[d] * mesh.data.size
                       == state.whole[k][0][d]
                       for k, d in state.layout.items() if d is not None))
    return out


def single_step(device, *, full: bool = False, hw: int = 32, batch: int,
                dtype=torch.float32) -> dict:
    """The one-process v1 step the mesh steps are held to."""
    cfg, loss_fn, params, b = _train_setup(device, full=full, hw=hw,
                                           batch=batch, dtype=dtype)
    state, metrics = _one_step(cfg, loss_fn, params(), b)
    out = dict(loss=float(metrics["loss"]),
               grad_norm=float(metrics["grad_norm"]), rows=_task_rows(state))
    del state
    return out


# ---------------------------------------------------------------------------
# sequence parallelism
# ---------------------------------------------------------------------------


def _whole(x: torch.Tensor, comm, fn) -> np.ndarray:
    """``fn`` on this rank's rows of ``x`` under the row context of
    ``comm``, the rows gathered back: numpy fp32."""
    with sequence.row_context(comm, min_seq=0):
        y = fn(sequence.share_rows(x, comm).contiguous())
        return comm.all_gather(y, 1).float().numpy()


def ring_check(comm, qkv: Sequence[np.ndarray]) -> np.ndarray:
    """``ops.ring_attention`` over ``comm`` on whole (B, S, N, D) q, k, v:
    this rank's tokens in, every rank's out gathered."""
    q, k, v = (torch.from_numpy(np.asarray(t, np.float32)) for t in qkv)
    out = ring_self_attention(*(sequence.share_rows(t, comm).contiguous()
                                for t in (q, k, v)), comm)
    return comm.all_gather(out, 1).numpy()


def ops_check(comm, seed: int = 5) -> dict:
    """GroupNorm, the fused and plain 3x3 convs, and the cuDNN convs (a 3x3
    SAME conv, the UNet's stride-2 pad-1 and the VAE's bottom-padded
    stride-2 downsample, the asymmetric decoder's 4x4 stride-2 pad-1) on
    this rank's rows, against the same op on the whole tensor: max |d|
    each, fp32. And one int8 unit's inputs and outputs (SP and whole) for
    the caller's flip bound."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 16, 8, 64, generator=g)
    gamma = 1 + 0.1 * torch.randn(64, generator=g)
    beta = 0.5 + 0.1 * torch.randn(64, generator=g)
    w = torch.randn(48, 64, 3, 3, generator=g) / 24.0
    b = 0.1 * torch.randn(48, generator=g)
    gn = dict(num_groups=32, eps=1e-5)
    cases = {
        "group_norm": lambda t: norms.group_norm(t, gamma, beta, silu=True, **gn),
        "conv3x3_gn_silu": lambda t: conv.conv3x3_gn_silu(t, w, b, gamma, beta,
                                                          **gn),
        "conv3x3": lambda t: conv.conv3x3(t, w, b),
    }
    torch.manual_seed(seed)  # the same modules on every rank
    cases.update(conv2d_3x3=Conv2D(64, 48, 3, padding=1),
                 downsample_pad1=Downsample2D(64),
                 vae_downsample=VAEDownsample2D(64),
                 conv2d_4x4_s2=Conv2D(64, 48, 4, stride=2, padding=1))
    out = {}
    with torch.no_grad():
        for name, fn in cases.items():
            want = fn(x).numpy()
            got = _whole(x, comm, fn)
            out[name] = float(np.abs(got - want).max())
        w_q, w_s = conv.quantize_weights_int8(w)
        unit = lambda t: conv.conv3x3_gn_silu_int8(  # noqa: E731
            t, w_q, w_s, b, gamma, beta, x_scale=8.0 / 127.0, **gn)
        out["int8"] = dict(x=x.numpy(), w_q=w_q.numpy(), w_s=w_s.numpy(),
                           bias=b.numpy(), gamma=gamma.numpy(),
                           beta=beta.numpy(), got=_whole(x, comm, unit),
                           want=unit(x).numpy())
    return out


def unet_check(comm, sample: np.ndarray, t: np.ndarray, ctx: np.ndarray,
               min_seq: int = 64) -> np.ndarray:
    """The tiny v1 UNet (``stack("v1")``'s weights, fp32) on this rank's
    rows of ``sample`` under the row context (self-attention of at least
    ``min_seq`` canvas tokens on the ring), the rows gathered."""
    cfg, state, _ = stack("v1", "cpu")
    unet = load_models(cfg, state, device="cpu",
                       dtype=torch.float32)["unet"]
    x = sequence.share_rows(torch.from_numpy(sample), comm).contiguous()
    with torch.no_grad(), sequence.row_context(comm, min_seq=min_seq):
        y = unet(x, torch.from_numpy(t), torch.from_numpy(ctx))
    return comm.all_gather(y, 1).numpy()


def _sp_call(kind: str, device, hw: int):
    """``kind``'s tiny fp32 stack, a ``hw``^2 image and mask, and the call's
    keywords (2 steps; ControlNet's control image)."""
    cfg, state, tok = stack(kind, device)
    img, mask = inputs(hw)
    kw = dict(prompt="a cat", num_inference_steps=2, seed=1)
    if kind == "cn":
        kw["control_image"] = edges(hw)
    return (cfg, state, tok), (img, mask), kw


def sp_pipeline_check(mesh, kind: str, *, hw: int, freeu: bool = False,
                      submit: bool = False) -> dict:
    """One call of ``kind``'s tiny pipeline in fp32 with
    ``sequence_parallel=True`` over ``mesh`` (``sp_min_seq`` 16, so every
    level's self-attention of a 128^2 or 256^2 canvas but the deepest
    rides the ring): its image and the launches of the call on this rank;
    with ``submit``, whether ``submit()`` gave the call's images; and that
    a canvas whose latent levels do not split is refused."""
    (cfg, state, tok), (img, mask), kw = _sp_call(kind, mesh.device, hw)
    pipe = pipeline(kind, cfg, state, tok, torch.float32, mesh=mesh,
                    sequence_parallel=True, sp_min_seq=16)
    if freeu:
        pipe.unet.freeu = SP_FREEU
    before = launch_counts()
    t0 = time.perf_counter()
    out = pipe(img, mask, **kw)
    seconds = time.perf_counter() - t0
    after = launch_counts()
    result = dict(image=out, seconds=seconds,
                  launches={k: after[k] - before[k] for k in after})
    if submit:
        result["submit_equal"] = bool(np.array_equal(
            pipe.submit(img, mask, **kw).result(), out))
    small = 8 << len(cfg.unet.block_out_channels) - 1  # deepest level: 1 row
    small_kw = dict(kw, control_image=edges(small)) if kind == "cn" else kw
    try:
        pipe(*inputs(small), **small_kw)
        result["refused"] = None
    except InputValidationError as e:
        result["refused"] = str(e)
    return result


def sp_reference(kind: str, device, *, hw: int, freeu: bool = False):
    """The call ``sp_pipeline_check`` makes, in this process alone."""
    (cfg, state, tok), (img, mask), kw = _sp_call(kind, device, hw)
    single = pipeline(kind, cfg, state, tok, torch.float32, device=device)
    if freeu:
        single.unet.freeu = SP_FREEU
    return single(img, mask, **kw)


SP_FREEU = FreeUConfig(1.5, 1.6, 0.9, 0.2)
# sp_checks' pipeline calls: (kind, on the model mesh, canvas, FreeU)
SP_CALLS = {"v1": ("v1", False, 256, False), "v2": ("v2", False, 256, False),
            "cn": ("cn", False, 256, False), "tp": ("v1", True, 128, True)}


def sp_checks(mesh_data, mesh_model, ring_inputs, unet_inputs) -> dict:
    """The sequence-parallel checks of the CPU world test: ring attention
    at data 4 (``ring_inputs[:2]``) and at data 2 x model 2
    (``ring_inputs[2]``), the row-split ops, the tiny UNet (``unet_inputs``:
    sample, t, context), v1, v2 and ControlNet at 256^2 on the data mesh,
    and v1 with FreeU at 128^2 on data 2 x model 2 (``SP_CALLS``, each
    ``sp_pipeline_check``; the ppt-v1 call's ``submit()``). Then rank r
    runs the one-process reference of the r-th of those four calls, every
    rank at once (a reference between the calls would hold the other
    ranks at the next call's first collective), and its uint8
    difference."""
    rank = dist.get_rank()
    out = {"ring": [ring_check(mesh_data.data, qkv) for qkv in ring_inputs[:2]]}
    out["ring_tp"] = ring_check(mesh_model.data, ring_inputs[2])
    out["ops"] = ops_check(mesh_data.data)
    out["unet"] = unet_check(mesh_data.data, *unet_inputs)
    for name, (kind, tp, hw, freeu) in SP_CALLS.items():
        out["sp_" + name] = sp_pipeline_check(
            mesh_model if tp else mesh_data, kind, hw=hw, freeu=freeu,
            submit=name == "v1")
    name = list(SP_CALLS)[rank]
    kind, _, hw, freeu = SP_CALLS[name]
    mine = out["sp_" + name]
    mine["reference"] = sp_reference(kind, mesh_data.device, hw=hw, freeu=freeu)
    mine.update(u8_diff(mine["image"], mine["reference"]))
    return out


# ---------------------------------------------------------------------------
# the rank functions
# ---------------------------------------------------------------------------


def world_rank(rank: int, devices: Sequence[str], backend: str,
               workdir: str, ring_inputs, unet_inputs) -> dict:
    """Every check of the CPU world test, on 4 ranks: v1, v2 and ControlNet
    at data 2 x model 2, a LoRA merged on that mesh, a data-parallel v1
    step at data 4, a ZeRO-3 step at data 4 against it (its state saved
    whole under ``workdir`` and loaded back into a placed one), a
    tensor-parallel step at data 2 x model 2 (the same), and the
    sequence-parallel checks on the caller's inputs (``sp_checks``)."""
    mesh22 = build_mesh(devices, model_parallel=2, backend=backend)
    mesh41 = build_mesh(devices, model_parallel=1, backend=backend)
    out = {kind: pipeline_check(mesh22, kind, batch=2, steps=2, hw=32)
           for kind in ("v1", "v2", "cn")}
    out["lora"] = lora_check(mesh22, steps=2, hw=32)
    ref = single_step(mesh22.device, batch=4)
    out["dp"] = train_check(mesh41, "dp", batch=4, reference=ref)
    out["zero3"] = train_check(mesh41, "zero3", batch=4, reference=ref,
                               checkpoint=f"{workdir}/zero3.npz")
    out["tp"] = train_check(mesh22, "tp", batch=4, reference=ref,
                            checkpoint=f"{workdir}/tp.npz")
    out["zero3"]["vs_dp"] = update_diff(out["dp"]["rows"], out["zero3"]["rows"])
    out.update(sp_checks(mesh41, mesh22, ring_inputs, unet_inputs))
    return out


def dryrun_rank(rank: int, devices: Sequence[str], backend: str,
                model_parallel: int) -> dict:
    """The dry run's checks on this rank, at the tiny configs in fp32 as
    the JAX dry run's (32^2, 2 steps): v1 and v2 over data x model (one
    image per data index), and a ZeRO-3 v1 step over every rank as the
    data axis (global batch max(2, ranks))."""
    mesh = build_mesh(devices, model_parallel=model_parallel, backend=backend)
    dp = build_mesh(devices, model_parallel=1, backend=backend)
    out = {kind: pipeline_check(mesh, kind, batch=mesh.data.size, steps=2,
                                hw=32)
           for kind in ("v1", "v2")}
    out["zero3"] = train_check(dp, "zero3", batch=max(2, dp.data.size))
    out["zero3"].pop("rows")
    return out


def _peak(device, reset: bool = False) -> Optional[int]:
    """The card's peak allocated bytes since the last reset (None on the
    CPU)."""
    if torch.device(device).type != "cuda":
        return None
    if reset:
        torch.cuda.reset_peak_memory_stats()
        return None
    return int(torch.cuda.max_memory_allocated())


# The ring against one launch over the whole K/V, both bf16: each rounds
# the output to bf16 once, from fp32 values that differ far less than a
# bf16 step (the hops round their probabilities to bf16 against each
# block's row maximum, the one launch against the whole row's), so an
# output differs by at most one step, which is at most 2^-7 of its size:
# within 2^-7 of the largest output, and of the output's 2-norm. No floor:
# a dropped hop or a merge with its weights swapped misses both bounds by
# 7 times or more (two CPU ranks, bf16 plain versions).
RING_RTOL = 2.0 ** -7


def attention_errors(got: torch.Tensor, want: torch.Tensor) -> dict:
    """``got`` against ``want``: the largest |difference|, it over the
    largest |want|, and the difference's 2-norm over ``want``'s (fp32)."""
    d, w = got.float() - want.float(), want.float()
    return dict(max_abs_err=float(d.abs().max()),
                max_rel_err=float(d.abs().max() / w.abs().max()),
                norm_rel_err=float(d.norm() / w.norm()))


def ring_against_one_launch(comm, device, shape, seed: int = 17) -> dict:
    """``ring_self_attention`` over ``comm`` on this rank's share of the
    tokens of seeded bf16 (B, S, N, D) q, k, v against one flash launch of
    the rank's q over the whole k and v: ``attention_errors``, the bound
    ``RING_RTOL`` and whether both relative errors are within it."""
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g, device=device).to(torch.bfloat16)
               for _ in range(3))
    mine = sequence.share_rows(q, comm).contiguous()
    got = ring_self_attention(mine, *(sequence.share_rows(t, comm).contiguous()
                                      for t in (k, v)), comm)
    err = attention_errors(got, flash_attention(mine, k, v))
    return dict(shape=list(shape), **err, rtol=RING_RTOL,
                ok=max(err["max_rel_err"], err["norm_rel_err"]) <= RING_RTOL)


def sp_card_check(mesh, cfg, state, tok, *, hw: int, steps: int,
                  seed: int) -> dict:
    """Part (e) of ``card_rank``: ppt-v1 with ``sequence_parallel=True``
    (``sp_min_seq`` 2048) over ``mesh``'s data group on one ``hw``^2
    canvas, bf16, against the one-process call, which rank 0 runs alone
    first (its seconds and peak bytes; the image broadcast). Each call is
    made twice, the second measured: seconds, peak bytes, launches, the
    copies staged through pinned memory on this rank. Then the ring alone
    at the canvas's level-0 and level-1 self-attention and the VAE's mid
    attention (``ring_against_one_launch``)."""
    dev, bf16 = mesh.device, torch.bfloat16
    img, mask = inputs(hw)
    kw = dict(prompt="a cat", num_inference_steps=steps, seed=seed)
    out, ref = {}, [None]
    if mesh.rank == 0:
        single = pipeline("v1", cfg, state, tok, bf16, device=dev)
        single(img, mask, **kw)
        _empty_cache(dev)
        _peak(dev, reset=True)
        _sync(dev)
        t0 = time.perf_counter()
        ref[0] = single(img, mask, **kw)
        _sync(dev)
        out.update(one_process_seconds=time.perf_counter() - t0,
                   one_process_peak_bytes=_peak(dev))
        del single
        _empty_cache(dev)
    dist.broadcast_object_list(ref, src=0)
    pipe = pipeline("v1", cfg, state, tok, bf16, mesh=mesh,
                    sequence_parallel=True)
    pipe(img, mask, **kw)
    _empty_cache(dev)
    _peak(dev, reset=True)
    before, staged = launch_counts(), dict(collectives.STAGED)
    _sync(dev)
    t0 = time.perf_counter()
    got = pipe(img, mask, **kw)
    _sync(dev)
    seconds = time.perf_counter() - t0
    after = launch_counts()
    out.update(u8_diff(got, ref[0]), seconds=seconds, peak_bytes=_peak(dev),
               launches={k: after[k] - before[k] for k in after},
               staged={k: collectives.STAGED[k] - staged[k] for k in staged})
    del pipe
    _empty_cache(dev)
    # the ring at the canvas's levels 0 and 1 and the VAE's mid attention
    out["ring"] = [ring_against_one_launch(mesh.data, dev, shape) for shape in (
        (2, (hw // 8) ** 2, 8, 40), (2, (hw // 16) ** 2, 8, 80),
        (1, (hw // 8) ** 2, 1, 512))]
    _empty_cache(dev)
    return out


def card_rank(rank: int, devices: Sequence[str], steps: int, hw: int,
              seeds: Sequence[int], train_hw: int, full: bool,
              sp_hw: int) -> dict:
    """The full-width checks of two ranks sharing one card over gloo
    (ppt-v1 at ``hw``, bf16): (a) a one-image call at data 1 x model 2,
    (b) a call of one image per seed at data 2 x model 1, each against
    this rank's one-process calls of the same seeds, with the launches and
    attention shapes of each mesh call, and the one-process batch of the
    seeds against the same calls alone; (e) sequence parallelism at data
    2 on one ``sp_hw``^2 canvas (``sp_card_check``);
    (c) a ZeRO-3 v1 step at data 2 (global batch 2 at ``train_hw``, bf16
    compute over fp32 masters) against the one-process step, which rank 0
    runs alone first."""

    tp = build_mesh(devices, model_parallel=2, backend="gloo")
    dp = build_mesh(devices, model_parallel=1, backend="gloo")
    dev, bf16 = tp.device, torch.bfloat16
    out = {"device": str(dev)}
    if dev.type == "cuda":
        out["current_device"] = torch.cuda.current_device()
    cfg, state, tok = stack("v1", dev, full=full, dtype=bf16)
    img, mask = inputs(hw)
    kw = dict(prompt="a cat", num_inference_steps=steps)
    single = pipeline("v1", cfg, state, tok, bf16, device=dev)
    single(img, mask, seed=0, **kw)  # warm-up: the libraries' plans
    refs = [single(img, mask, seed=s, **kw) for s in seeds]
    # the one-process spread (a)'s bound stands on: the same images
    # batched against alone
    batched = single(img, mask, seed=list(seeds),
                     num_images_per_prompt=len(seeds), **kw)
    out["batch_vs_alone"] = u8_diff(batched, np.concatenate(refs))
    del single
    for name, mesh, call_kw, want in (
            ("tp", tp, dict(seed=seeds[0]), refs[0]),
            ("dp", dp, dict(seed=list(seeds), num_images_per_prompt=len(seeds)),
             np.concatenate(refs))):
        pipe = pipeline("v1", cfg, state, tok, bf16, mesh=mesh)
        before = launch_counts()
        _sync(dev)
        t0 = time.perf_counter()
        with AttentionShapes() as seen:
            got = pipe(img, mask, **call_kw, **kw)
        _sync(dev)
        after = launch_counts()
        out[name] = dict(u8_diff(got, want), seconds=time.perf_counter() - t0,
                         launches={k: after[k] - before[k] for k in after},
                         attention_shapes=sorted(seen.shapes),
                         equal_images=[bool(np.array_equal(g, w))
                                       for g, w in zip(got, want)])
        del pipe
    _empty_cache(dev)
    out["sp"] = sp_card_check(dp, cfg, state, tok, hw=sp_hw, steps=steps,
                              seed=seeds[0])
    del state
    _empty_cache(dev)

    ref = [None]
    if rank == 0:  # alone: the one-process step's memory is the largest
        _peak(dev, reset=True)
        ref[0] = single_step(dev, full=full, hw=train_hw, batch=2, dtype=bf16)
        out["ref_peak_bytes"] = _peak(dev)
        _empty_cache(dev)
    dist.broadcast_object_list(ref, src=0)
    _peak(dev, reset=True)
    z = train_check(dp, "zero3", full=full, hw=train_hw, batch=2, dtype=bf16,
                    reference=ref[0])
    z["peak_bytes"] = _peak(dev)
    out["zero3"] = z
    return out


def nccl_rank(rank: int, devices: Sequence[str], hw: int, batch: int,
              full: bool = True, backend: str = "nccl") -> dict:
    """World size 1 over NCCL (CUDA tensors to the collectives as they
    are): a data-parallel and a ZeRO-3 full-width v1 step against the
    one-process step, each from the same fresh state, compared bit for
    bit (loss, grad_norm, every parameter). cuDNN runs its deterministic
    algorithms here, so that two runs of one step can be equal at all."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    mesh = build_mesh(devices, backend=backend)
    dev, bf16 = mesh.device, torch.bfloat16
    cfg, loss_fn, params, b = _train_setup(dev, full=full, hw=hw, batch=batch,
                                           dtype=bf16)
    out = {"device": str(dev), "backend": mesh.backend}

    def run(place):
        state, m = _one_step(cfg, loss_fn, params(), b, place=place)
        return m, flatten(gather_state(state).params)

    plain_m, plain = run(None)
    _empty_cache(dev)
    for name, place in (("dp", lambda s: replicate_state(mesh, s)),
                        ("zero3", lambda s: fsdp_state(mesh, s)[0])):
        m, flat = run(place)
        out[name] = {
            "loss_equal": bool(torch.equal(m["loss"], plain_m["loss"])),
            "grad_norm_equal": bool(torch.equal(m["grad_norm"],
                                                plain_m["grad_norm"])),
            "params_equal": sum(torch.equal(flat[k], plain[k]) for k in plain),
            "params": len(plain), "loss": float(m["loss"])}
        del flat
        _empty_cache(dev)
    out["loss"] = float(plain_m["loss"])
    return out


def _empty_cache(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def check_dryrun(results: List[dict], u8_max: int = U8_MAX,
                 loss_rtol: float = LOSS_RTOL) -> List[str]:
    """The failures of a dry run's results against its bounds."""
    bad = []
    for rank, r in enumerate(results):
        for kind in ("v1", "v2"):
            if r[kind]["max"] > u8_max:
                bad.append(f"rank {rank} {kind}: max uint8 diff "
                           f"{r[kind]['max']} > {u8_max}")
        z = r["zero3"]
        if not abs(z["loss"] - z["ref_loss"]) <= loss_rtol * max(1.0, abs(z["ref_loss"])):
            bad.append(f"rank {rank} zero3: loss {z['loss']} against "
                       f"{z['ref_loss']}")
        if z["update"]["max"] > STEP_MAX or z["update"]["tight"] < TIGHT_SHARE:
            bad.append(f"rank {rank} zero3: update {z['update']}")
        if not z["layout_kept"]:
            bad.append(f"rank {rank} zero3: the layout was not kept")
    return bad


def main(argv=None) -> int:
    p = argparse.ArgumentParser("powerpaint_tpu_torch.parallel.dryrun")
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--model-parallel", type=int, default=2)
    p.add_argument("--device", default="cpu",
                   help="cpu, or cuda: ranks on cuda:0.. (or all on cuda:0 "
                        "under --backend gloo)")
    p.add_argument("--backend", default=None, choices=[None, "gloo", "nccl"])
    args = p.parse_args(argv)

    n = args.ranks
    if args.device == "cpu":
        devices, threads = ["cpu"] * n, cpu_threads(n)
    elif args.backend == "gloo":
        devices, threads = ["cuda:0"] * n, None
    else:
        devices, threads = [f"cuda:{r}" for r in range(n)], None
    t0 = time.perf_counter()
    backend = choose_backend(devices, args.backend)
    results = spawn(dryrun_rank, devices,
                    (devices, backend, args.model_parallel),
                    backend=backend, threads=threads)
    for rank, r in enumerate(results):
        z = r["zero3"]
        print(f"[dryrun +{time.perf_counter() - t0:6.1f}s] rank {rank}: "
              f"v1 max|d| {r['v1']['max']}, v2 max|d| {r['v2']['max']}, "
              f"ZeRO-3 loss {z['loss']} (one process {z['ref_loss']}), "
              f"update {z['update']}, {z['bytes_at_rest']} of "
              f"{z['whole_bytes']} large-leaf bytes at rest", flush=True)
    bad = check_dryrun(results)
    if bad:
        print("dryrun FAILED:\n  " + "\n  ".join(bad), flush=True)
        return 1
    r0 = results[0]
    print(f"dryrun OK: {n} ranks, data {n // args.model_parallel} x model "
          f"{args.model_parallel}; v1 max|d|={r0['v1']['max']}, v2 "
          f"max|d|={r0['v2']['max']}; ZeRO-3 v1 step loss "
          f"{r0['zero3']['loss']:.4f} (one process {r0['zero3']['ref_loss']:.4f}), "
          f"{r0['zero3']['big_share']:.3f} of the largest leaf a rank",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

