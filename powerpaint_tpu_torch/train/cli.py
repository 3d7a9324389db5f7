"""Training CLI: fine-tune PowerPaint stacks on a folder of images (the JAX
package's ``train/cli.py``, every flag of its parser).

    python -m powerpaint_tpu_torch.train.cli \\
        --mode lora --data /path/to/images --steps 2000 \\
        --checkpoint_dir checkpoints/ppt-v1 --out runs/style_lora

Modes (see train/step.trainable_mask):
  v1           full v1 fine-tune (UNet + text encoder + task tokens)
  task_tokens  only the P_ctxt/P_shape/P_obj rows (textual-inversion style)
  v2           BrushNet branch + its text encoder (base frozen)
  lora         rank-r adapters on attention/FF; exports a state dict
               loadable by io/lora (and by diffusers)
  lcm_distill  LCM-LoRA consistency distillation of the stack

Without --checkpoint_dir a random-init stack is used (smoke runs); without
--data the procedural SyntheticSource is used. It runs on the card
(``--device cuda``) unless asked for the CPU. The final weights go to
``<out>/weights`` in the reference checkpoint layout (serve them with
``--checkpoint_dir <out>/weights``), or to ``<out>/lora.npz`` (serve with
``--lora``). ``POWERPAINT_INT8=1`` is refused, since the int8 units
quantise their weights with a rounding that has no gradient.

``--mesh N`` trains data-parallel over N ranks that this command starts
itself (``parallel.launch.spawn``): ``cuda:0`` .. ``cuda:N-1`` over NCCL,
or N gloo processes on the CPU under ``--device cpu``; N above the
host's card count is refused. ``--batch_size`` is the global batch, which
N must divide. ``--fsdp`` with it places the state ZeRO-3
(``train.step.fsdp_state``); without ``--mesh`` it is ignored, as in the
JAX package. Rank 0 logs and writes everything, gathered whole, so the
files are those of a one-process run.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("powerpaint_tpu_torch.train")
    p.add_argument("--mode", default="lora",
                   choices=["v1", "task_tokens", "v2", "lora",
                            "lcm_distill"])
    p.add_argument("--version", default=None,
                   choices=[None, "ppt-v1", "ppt-v2"],
                   help="model generation (default: ppt-v2 for --mode v2, "
                        "else ppt-v1)")
    p.add_argument("--checkpoint_dir", default=None,
                   help="reference checkpoint layout to start from "
                        "(io/checkpoint); random init if omitted")
    p.add_argument("--data", default=None,
                   help="image folder (optional <stem>.txt captions); "
                        "synthetic data if omitted")
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--lr", type=float, default=None,
                   help="default: 1e-5 (v1/v2), 5e-4 (task_tokens), "
                        "1e-4 (lora)")
    p.add_argument("--weight_decay", type=float, default=1e-2)
    p.add_argument("--accumulate", type=int, default=1,
                   help="gradient accumulation: average N micro-batch "
                        "gradients per optimizer update (effective batch "
                        "= batch_size * N)")
    p.add_argument("--snr_gamma", type=float, default=None,
                   help="min-SNR loss weighting (5.0 is the common value)")
    p.add_argument("--lora_rank", type=int, default=8)
    p.add_argument("--ema", type=float, default=None,
                   help="EMA decay (e.g. 0.9999); off by default")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="runs/train",
                   help="output dir: state.npz (resumable), metrics.jsonl, "
                        "final weights (weights/, the reference layout) or "
                        "lora.npz")
    p.add_argument("--resume", action="store_true",
                   help="resume from <out>/state.npz")
    p.add_argument("--log_every", type=int, default=25)
    p.add_argument("--ckpt_every", type=int, default=250)
    p.add_argument("--mesh", type=int, default=0,
                   help="data-parallel over N ranks, one process each, "
                        "started by this command (0 = one process)")
    p.add_argument("--fsdp", action="store_true",
                   help="with --mesh: fully shard params/optimizer/EMA "
                        "over the data axis (ZeRO-3) instead of "
                        "replicating — ~1/N state bytes per rank")
    p.add_argument("--tiny", action="store_true",
                   help="tiny config smoke run (CPU-friendly)")
    p.add_argument("--weight_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="compute dtype (params/optimizer stay fp32)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: the card)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if os.environ.get("POWERPAINT_INT8", "0") == "1":
        raise SystemExit("POWERPAINT_INT8=1 is inference only: the int8 "
                         "units round their weights, which has no gradient")
    if not args.mesh:
        return train(args)

    import torch

    from powerpaint_tpu_torch.parallel.launch import cpu_threads, spawn

    n = args.mesh
    if args.device == "cpu":
        devices, threads = ["cpu"] * n, cpu_threads(n)
    else:
        cards = torch.cuda.device_count()
        if n > cards:
            raise SystemExit(f"--mesh {n} needs {n} cards, one per rank; "
                             f"this host has {cards}")
        devices, threads = [f"cuda:{r}" for r in range(n)], None
    spawn(_train_rank, devices, (args, devices), threads=threads)
    return 0


def _train_rank(rank: int, args, devices) -> None:
    """One rank of ``--mesh``: the mesh over ``devices``, then ``train``."""
    from powerpaint_tpu_torch.parallel.mesh import build_mesh

    train(args, build_mesh(devices))


def train(args, mesh=None) -> int:
    """The run ``args`` asks for, in this process: alone, or as one rank of
    ``mesh`` (``--fsdp``: ZeRO-3)."""
    import torch

    from powerpaint_tpu_torch.io.checkpoint import save_native
    from powerpaint_tpu_torch.io.weights import (
        FAMILIES,
        V2_FAMILIES,
        build_models,
        init_state,
    )
    from powerpaint_tpu_torch.text.tokenizer import (
        HashTokenizer,
        TokenizerWrapper,
        add_task_tokens,
    )
    from powerpaint_tpu_torch.train import distill, loss as L
    from powerpaint_tpu_torch.train.data import (
        FolderSource,
        SyntheticSource,
        batches,
        prefetch,
    )
    from powerpaint_tpu_torch.train.lora import init_lora_tree, save_lora_npz
    from powerpaint_tpu_torch.train.step import (
        AdamW,
        fsdp_state,
        gather_state,
        init_train_state,
        make_train_step,
        replicate_state,
        trainable_mask,
    )
    from powerpaint_tpu_torch.train.trainer import Trainer, load_train_state

    version = args.version or ("ppt-v2" if args.mode == "v2" else "ppt-v1")
    dtype = torch.bfloat16 if args.weight_dtype == "bfloat16" else torch.float32
    device = torch.device(args.device) if mesh is None else mesh.device
    writer = mesh is None or mesh.rank == 0

    # ---- model stack (fp32 masters on the device)
    if args.checkpoint_dir:
        from powerpaint_tpu_torch.io.checkpoint import load_ppt_v1, load_ppt_v2

        kw = {}
        if args.tiny:
            from powerpaint_tpu_torch.testing import tiny_v1_config, tiny_v2_config

            kw["config"] = (tiny_v1_config() if version == "ppt-v1"
                            else tiny_v2_config())
        pipe = (load_ppt_v1 if version == "ppt-v1" else load_ppt_v2)(
            args.checkpoint_dir, dtype=torch.float32, device=device, **kw)
        cfg, tok = pipe.config, pipe.tokenizer
        params = {f: {k: v.detach() for k, v in getattr(pipe, f).state_dict().items()}
                  for f in (FAMILIES if version == "ppt-v1" else V2_FAMILIES)}
    else:
        if args.tiny:
            from powerpaint_tpu_torch.testing import tiny_v1_config, tiny_v2_config

            cfg = tiny_v1_config() if version == "ppt-v1" else tiny_v2_config()
        else:
            from powerpaint_tpu_torch.core.config import (
                ppt_v1_config,
                ppt_v2_config,
            )

            cfg = ppt_v1_config() if version == "ppt-v1" else ppt_v2_config()
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = init_state(cfg, gen, device=device)
        # the hash vocab MUST match the config's vocab_size: reloading the
        # saved weights rebuilds the tokenizer from the table's rows
        tok = TokenizerWrapper(
            HashTokenizer(vocab_size=cfg.text_encoder.vocab_size))
        add_task_tokens(tok)
    params = channels_last(params)

    # ---- data
    hw = 32 if args.tiny else args.resolution
    src = (FolderSource(args.data, hw=hw, seed=args.seed) if args.data
           else SyntheticSource(hw=hw, seed=args.seed))
    data = prefetch(
        batches(src, tok, args.batch_size, version=version, seed=args.seed),
        size=2,
    )

    # ---- loss + optimizer + state
    base_loss = (L.make_v2_loss if version == "ppt-v2" else L.make_v1_loss)(
        cfg, dtype=dtype, snr_gamma=args.snr_gamma)
    draw = functools.partial(L.draw, cfg)
    lr_default = {"v1": 1e-5, "v2": 1e-5, "task_tokens": 5e-4,
                  "lora": 1e-4, "lcm_distill": 1e-4}[args.mode]
    lr = args.lr if args.lr is not None else lr_default

    if args.mode in ("lora", "lcm_distill"):
        gen = torch.Generator(device=device).manual_seed(args.seed + 1)
        lora = init_lora_tree(build_models(cfg)["unet"], args.lora_rank, gen)
        if args.mode == "lcm_distill":
            mk = (distill.make_lcm_distill_loss_v2 if version == "ppt-v2"
                  else distill.make_lcm_distill_loss)
            loss_fn = mk(cfg, params, dtype=dtype)
            draw = functools.partial(distill.draw, cfg)
        else:
            loss_fn = L.make_lora_loss(base_loss, params)
        tx = AdamW(lr, weight_decay=args.weight_decay,
                   accumulate_steps=args.accumulate)
        state = init_train_state(lora, tx, ema=args.ema is not None)
    else:
        tx = AdamW(lr, weight_decay=args.weight_decay,
                   labels=trainable_mask(params, args.mode),
                   accumulate_steps=args.accumulate)
        loss_fn = base_loss
        state = init_train_state(params, tx, ema=args.ema is not None)

    os.makedirs(args.out, exist_ok=True)
    ckpt = os.path.join(args.out, "state.npz")
    if args.resume:
        state = load_train_state(ckpt, state)
        if writer:
            print(f"resumed from {ckpt} at step {state.step}")
    if mesh is not None:
        if args.fsdp:
            state, _ = fsdp_state(mesh, state)
        else:
            state = replicate_state(mesh, state)

    step_fn = make_train_step(loss_fn, tx, ema_decay=args.ema, draw=draw)
    metrics_path = os.path.join(args.out, "metrics.jsonl")

    def on_log(step, m):
        print(json.dumps(m), flush=True)
        with open(metrics_path, "a") as fh:
            fh.write(json.dumps(m) + "\n")

    trainer = Trainer(step_fn, state, data, seed=args.seed, mesh=mesh)
    trainer.fit(args.steps, log_every=args.log_every, ckpt_path=ckpt,
                ckpt_every=args.ckpt_every, on_log=on_log)

    # ---- final artifacts
    final = final_params(gather_state(trainer.state))
    if not writer:
        return 0
    if args.mode in ("lora", "lcm_distill"):
        out = os.path.join(args.out, "lora.npz")
        save_lora_npz(out, final)
        hint = (" — serve with scheduler='lcm', guidance_scale=1"
                if args.mode == "lcm_distill" else "")
        print(f"wrote {out} (loadable via io/lora or --lora on the "
              f"CLI){hint}")
    else:
        out = os.path.join(args.out, "weights")
        save_native(out, cfg, final)
        print(f"wrote {out} (the reference layout; serve with "
              f"--checkpoint_dir {out})")
    print(f"wrote {ckpt} (resume with --resume)")
    return 0


def channels_last(params: dict) -> dict:
    """A stack's state dicts with every 4-D (conv) weight in channels-last
    memory, the layout the conv kernel reads (``io.weights.load_models``
    stores inference weights so)."""
    import torch

    return {f: {k: v.contiguous(memory_format=torch.channels_last)
                if v.dim() == 4 else v for k, v in sd.items()}
            for f, sd in params.items()}


def final_params(state) -> dict:
    """The EMA (unflattened) where the state keeps one, else the params."""
    if state.ema is None:
        return state.params
    out: dict = {}
    for key, t in state.ema.items():
        *path, leaf = key.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t
    return out


if __name__ == "__main__":
    sys.exit(main())
