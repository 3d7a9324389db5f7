"""Training loop + exact-resume checkpointing: the JAX package's
``train/trainer.py``.

The loop is host-side and thin (the train step owns all compute) and reads
a metric back to the host only on a log step. The checkpoint is one
``.npz`` of the train state with named keys (``step``,
``params/<family>/<name>``, ``opt/<count|mini_step|gradient_step>``,
``opt/<mu|nu|acc>/<leaf>``, ``ema/<leaf>``), restored into a template
state of the same configuration: exact resume, no pickle. Final model
weights go through ``io.checkpoint.save_native`` for serving.

On a mesh (``Trainer(mesh=)``) only rank 0 logs and writes: a placed
state (ZeRO-3 or tensor-parallel pieces) is gathered whole first, every
rank taking part, into the same file one process writes; loading cuts
each rank's pieces from it. So a mesh run resumes in one process and the
other way round.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from powerpaint_tpu_torch.train.step import (
    TrainState,
    cut_leaf,
    flatten,
    gather_state,
)

_SCALARS = ("count", "mini_step", "gradient_step")


def _tensors(state: TrainState) -> dict:
    """The state's tensors under their checkpoint names."""
    out = {"params/" + k: v for k, v in flatten(state.params).items()}
    for k, v in state.opt_state.items():
        if k not in _SCALARS:
            out.update({f"opt/{k}/{n}": t for n, t in v.items()})
    if state.ema is not None:
        out.update({"ema/" + k: v for k, v in state.ema.items()})
    return out


def save_train_state(path: str, state: TrainState) -> None:
    """Write ``state`` (gathered whole first on a mesh, where every rank
    calls this and rank 0 writes)."""
    if state.mesh is not None:
        rank = state.mesh.rank
        state = gather_state(state)
        if rank != 0:
            return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"  # np.savez appends .npz unless present
    arrays = {k: t.detach().cpu().numpy() for k, t in _tensors(state).items()}
    arrays["step"] = np.int64(state.step)
    arrays.update({f"opt/{k}": np.int64(state.opt_state[k]) for k in _SCALARS})
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def load_train_state(path: str, template: TrainState) -> TrainState:
    """Restore into ``template`` (same model/optimizer config), in place:
    every tensor of the template is overwritten, on its device and in its
    dtype; names and shapes must match (a placed template's pieces take
    their cut of the whole tensors)."""
    want = _tensors(template)
    names = set(want) | {"step"} | {f"opt/{k}" for k in _SCALARS}
    with np.load(path) as z:
        if set(z.files) != names:
            missing = sorted(names - set(z.files))[:3]
            extra = sorted(set(z.files) - names)[:3]
            raise ValueError(f"checkpoint {path!r} does not match the state: "
                             f"missing {missing}, unexpected {extra} — "
                             "model/optimizer config mismatch")
        for k, t in want.items():
            # a placed template holds its rank's piece of the leaf
            leaf = k.split("/", 2 if k.startswith("opt/") else 1)[-1]
            arr = cut_leaf(template, leaf, torch.from_numpy(z[k]))
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"{k}: checkpoint shape {arr.shape} != "
                                 f"state {tuple(t.shape)}")
            with torch.no_grad():
                t.copy_(arr)
        template.step = int(z["step"])
        for k in _SCALARS:
            template.opt_state[k] = int(z[f"opt/{k}"])
    return template


@dataclasses.dataclass
class Trainer:
    """Minimal production loop: metrics history, periodic checkpoints,
    exact resume. ``step_fn`` comes from ``train.step.make_train_step``
    (with its ``draw``); ``data`` yields ``train.data.batches`` dicts (on
    a mesh, every rank the same global batches). ``mesh``: only its rank
    0 logs (``on_log``) and writes the checkpoint."""

    step_fn: Callable
    state: TrainState
    data: Iterator[Dict[str, np.ndarray]]
    seed: int = 0
    mesh: Optional[object] = None

    def fit(
        self,
        num_steps: int,
        *,
        log_every: int = 10,
        ckpt_path: Optional[str] = None,
        ckpt_every: int = 0,
        on_log: Optional[Callable[[int, Dict[str, float]], None]] = None,
    ) -> List[Dict[str, float]]:
        history: List[Dict[str, float]] = []
        t0 = time.time()
        for _ in range(num_steps):
            batch = next(self.data)
            self.state, metrics = self.step_fn(self.state, batch, self.seed)
            step = self.state.step
            if log_every and (step % log_every == 0 or step == 1):
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step
                m["wall_s"] = round(time.time() - t0, 2)
                history.append(m)
                if on_log and (self.mesh is None or self.mesh.rank == 0):
                    on_log(step, m)
            if ckpt_path and ckpt_every and step % ckpt_every == 0:
                save_train_state(ckpt_path, self.state)
        if ckpt_path:
            save_train_state(ckpt_path, self.state)
        return history
