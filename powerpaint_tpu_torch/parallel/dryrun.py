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
from powerpaint_tpu_torch.io.weights import init_state
from powerpaint_tpu_torch.models import transformer
from powerpaint_tpu_torch.ops import conv, norms
from powerpaint_tpu_torch.ops.flash_attention import flash_attention
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


def pipeline(kind: str, cfg, state, tok, dtype, mesh=None, device=None):
    cls = {"v1": InpaintPipeline, "v2": BrushNetPipeline,
           "cn": ControlNetPipeline}[kind]
    return cls(cfg, state, tok, dtype=dtype, device=device, mesh=mesh)


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
    """The hand kernels' launch counters (B1-B5) of this process."""
    return {"flash_attention": flash_attention.launches,
            "conv3x3_gn_silu": conv.conv3x3_gn_silu.launches,
            "conv3x3": conv.conv3x3.launches,
            "group_norm": norms.group_norm.launches,
            "group_norm_stats": norms.group_norm_stats.launches,
            "layer_norm": norms.layer_norm.launches}


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
# the rank functions
# ---------------------------------------------------------------------------


def world_rank(rank: int, devices: Sequence[str], backend: str,
               workdir: str) -> dict:
    """Every check of the CPU world test, on 4 ranks: v1, v2 and ControlNet
    at data 2 x model 2, a LoRA merged on that mesh, a data-parallel v1
    step at data 4, a ZeRO-3 step at data 4 against it (its state saved
    whole under ``workdir`` and loaded back into a placed one), and a
    tensor-parallel step at data 2 x model 2 (the same)."""
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


def card_rank(rank: int, devices: Sequence[str], steps: int, hw: int,
              seeds: Sequence[int], train_hw: int, full: bool = True) -> dict:
    """The full-width checks of two ranks sharing one card over gloo
    (ppt-v1 at ``hw``, bf16): (a) a one-image call at data 1 x model 2,
    (b) a call of one image per seed at data 2 x model 1, each against
    this rank's one-process calls of the same seeds, with the launches and
    attention shapes of each mesh call, and the one-process batch of the
    seeds against the same calls alone; (c) a ZeRO-3 v1 step at data 2
    (global batch 2 at ``train_hw``, bf16 compute over fp32 masters)
    against the one-process step, which rank 0 runs alone first."""

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
