"""The train step: optimizer, freezing labels, accumulation, EMA, and its
placement over a mesh; the JAX package's ``train/step.py``.

The optimizer is ``optax.adamw`` as the JAX package builds it
(``make_optimizer``), written out on flat dicts of tensors keyed
``"<family>/<name>"`` (or ``"<module>/down"`` for a LoRA tree), the JAX
tree's '/'-joined paths in the port's names:

- freezing is ``optax.multi_transform`` with ``set_to_zero`` on the frozen
  leaves (``trainable_mask``): they are never written;
- the global-norm clip sees the TRAINED leaves only (it sits inside the
  multi_transform), then Adam (b1 0.9, b2 0.999, eps 1e-8, the bias
  corrections of the step count), decoupled weight decay ``+ wd * p``, and
  ``* -lr``, applied as ``p + u``;
- ``accumulate_steps`` N is ``optax.MultiSteps``: the running mean ``acc +
  (g - acc) / (n + 1)`` of N micro-step gradients feeds one update, and
  params do not move on the other micro-steps;
- EMA ``e * d + p * (1 - d)`` over every leaf, on every call (micro-steps
  too), as the JAX step does;
- ``grad_norm`` is the global norm over every leaf that gets a gradient,
  frozen ones included (in ``v2`` the base UNet and the plain text
  encoder, in ``task_tokens`` all but the VAE): the JAX step's
  ``optax.global_norm(grads)``.

Parameters, moments and EMA are updated in place (the JAX step donates its
state), under ``torch.no_grad()``.

Over a mesh (``parallel.mesh``; the state's placement says which, as the
JAX arrays' shardings do), every rank runs the same step on the same GLOBAL
batch and draws, and keeps its data share's rows of both, so N ranks see
the noise and timesteps one process sees:

- ``replicate_state``: data parallel; each rank holds the whole state, the
  gradients are averaged over the data group before the update, ``loss``
  and every metric are global means;
- ``replicate_state(tensor_parallel=True, models=...)``: the models' heads
  and MLP hidden dims split over the model group (``parallel.mesh.
  shard_model``), each rank holding and updating its pieces;
- ``fsdp_state``: ZeRO-3; each rank holds 1/N of every large leaf's
  parameters, moments and EMA (``parallel.mesh.fsdp_layout``), gathers
  every leaf whole before the forward, and reduce-scatters the gradients
  onto its pieces, which it updates. The layout is kept step after step.

The clip norm and ``grad_norm`` are global: each leaf's sum of squares is
summed over the ranks that split it and counted once where it is
replicated. With one rank every collective returns its input, and the
step is the one-process step bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from powerpaint_tpu_torch.parallel.mesh import fsdp_layout, shard_model

_TASK_ROWS = ("text_encoder/text_model.embeddings.token_embedding."
              "trainable_embeddings.")
_PREDICATES = {
    "all": lambda p: True,
    "v1": lambda p: p.startswith(("unet/", "text_encoder/")),
    "task_tokens": lambda p: p.startswith(_TASK_ROWS),
    "v2": lambda p: p.startswith(("brushnet/", "text_encoder_brushnet/")),
}


def flatten(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """``{family: {name: tensor}}`` (or a LoRA tree) -> ``{"family/name":
    tensor}``: views of the same tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def trainable_mask(params: dict, mode: str) -> Dict[str, bool]:
    """Which leaves train (``True``) and which are frozen, by mode:

    - "all": everything (LoRA factor trees);
    - "v1": UNet + text encoder (task-token rows included); VAE frozen;
    - "task_tokens": only the text encoder's task-token rows;
    - "v2": BrushNet branch + its task text encoder; base UNet, plain
      text encoder and VAE frozen."""
    if mode not in _PREDICATES:
        raise ValueError(f"unknown mode {mode!r}; one of {sorted(_PREDICATES)}")
    pred = _PREDICATES[mode]
    return {k: pred(k) for k in flatten(params)}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of every tensor's sum of squares (fp32)."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


def sharded_norm(tensors: Dict[str, torch.Tensor], split: Sequence[str],
                 comm) -> torch.Tensor:
    """``global_norm`` of a tree whose leaves ``split`` are each rank's
    pieces over ``comm`` (their sums of squares summed over it, in one
    collective) and whose other leaves are whole on every rank (counted
    once); the leaves' sums added in ``tensors``' order, as
    ``global_norm`` adds them."""
    keys = list(tensors)
    sums = [torch.sum(t.float() * t.float()) for t in tensors.values()]
    cut = [k in split for k in keys]
    if any(cut):
        vec = torch.stack([s if c else torch.zeros_like(s)
                           for s, c in zip(sums, cut)])
        summed = comm.all_reduce(vec)
        sums = [summed[i] if c else s for i, (s, c) in enumerate(zip(sums, cut))]
    return torch.sqrt(sum(sums))


@dataclasses.dataclass
class AdamW:
    """``make_optimizer`` of the JAX package: AdamW (+ clip, + freezing
    labels, + accumulation)."""

    learning_rate: float = 1e-5
    weight_decay: float = 1e-2
    clip_norm: Optional[float] = 1.0
    labels: Optional[Dict[str, bool]] = None
    accumulate_steps: int = 1
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def trained(self, flat: Dict[str, torch.Tensor]):
        return [k for k in flat if self.labels is None or self.labels[k]]

    def init(self, params: dict) -> dict:
        flat = flatten(params)
        keys = self.trained(flat)
        zeros = lambda: {k: torch.zeros_like(flat[k]) for k in keys}  # noqa: E731
        state = {"count": 0, "mu": zeros(), "nu": zeros(),
                 "mini_step": 0, "gradient_step": 0}
        if self.accumulate_steps > 1:
            state["acc"] = zeros()
        return state

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: dict,
               params: dict, norm: Optional[Callable] = None) -> None:
        """One call with ``grads`` (flat, the trained leaves at least):
        updates ``params`` and ``state`` in place. ``norm(grads)``, the
        clip's global norm of a flat tree (``global_norm`` of its leaves
        by default; ``sharded_norm`` on a split state)."""
        flat = flatten(params)
        keys = self.trained(flat)
        k_steps = self.accumulate_steps
        if k_steps > 1:
            n = state["mini_step"]
            for k in keys:
                acc = state["acc"][k]
                acc.add_((grads[k] - acc) / (n + 1))
            emit = n == k_steps - 1
            state["mini_step"] = (n + 1) % k_steps
            if not emit:
                return
            g = {k: state["acc"][k].clone() for k in keys}
            for k in keys:
                state["acc"][k].zero_()
            state["gradient_step"] += 1
        else:
            g = {k: grads[k] for k in keys}
        if self.clip_norm:
            g_norm = norm(g) if norm is not None else global_norm(g.values())
            if not bool(g_norm < self.clip_norm):
                g = {k: (v / g_norm) * self.clip_norm for k, v in g.items()}
        state["count"] += 1
        count = state["count"]
        # the bias corrections in fp32, as optax computes them
        bc1 = float(1 - torch.tensor(self.b1, dtype=torch.float32) ** count)
        bc2 = float(1 - torch.tensor(self.b2, dtype=torch.float32) ** count)
        for k in keys:
            p, mu, nu = flat[k], state["mu"][k], state["nu"][k]
            mu.copy_((1 - self.b1) * g[k] + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g[k] * g[k]) + self.b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            u = (u + self.weight_decay * p) * -self.learning_rate
            p.add_(u)


@dataclasses.dataclass
class TrainState:
    step: int
    params: dict  # the OPTIMIZED tree (model families, or a LoRA tree)
    opt_state: dict
    ema: Optional[Dict[str, torch.Tensor]]  # flat, or None
    # the placement over a mesh (None: one process), as the JAX arrays'
    # shardings: the mesh; ZeRO-3's split dim of each flat leaf and the
    # whole leaves' (shape, stride); the tensor-parallel cut of each leaf
    mesh: Optional[object] = None
    layout: Optional[Dict[str, Optional[int]]] = None
    whole: Optional[Dict[str, tuple]] = None
    tp_plan: Optional[dict] = None


def init_train_state(params: dict, tx: AdamW, *, ema: bool = False) -> TrainState:
    return TrainState(
        step=0, params=params, opt_state=tx.init(params),
        ema={k: v.detach().clone() for k, v in flatten(params).items()}
        if ema else None)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one step's draws: seeded from (seed, step), so a
    resumed run draws what an unbroken one draws (the JAX step's
    ``fold_in(rng, step)``)."""
    s = int(np.random.SeedSequence([seed, step]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(s)


def make_train_step(loss_fn: Callable, tx: AdamW, *,
                    ema_decay: Optional[float] = None,
                    draw: Optional[Callable] = None) -> Callable:
    """(state, batch, draws) -> (state', metrics), in place. ``draws``: the
    step's random numbers for ``loss_fn``, or an int seed, from which
    ``draw(batch, generator)`` makes them with ``step_generator``.
    Gradients are taken for every leaf of ``loss_fn.families`` (every leaf
    of the tree when None), requires_grad set only for the call, in grad
    mode whatever the caller's."""

    def step(state: TrainState, batch, draws):
        if not isinstance(draws, dict):
            dev = next(iter(flatten(state.params).values())).device
            draws = draw(batch, step_generator(int(draws), state.step, dev))
        mesh = state.mesh
        if mesh is not None:  # this rank's rows of the global batch
            batch, draws = shard_batch(mesh, batch), shard_batch(mesh, draws)
        families = getattr(loss_fn, "families", None)
        params = state.params
        whole = params if state.layout is None else gather_params(state)
        differentiated = flatten(
            whole if families is None
            else {f: whole[f] for f in families if f in whole})
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in differentiated.items()}
        with torch.enable_grad():  # whatever the caller's grad mode
            loss, metrics = loss_fn(with_leaves(whole, leaves), batch, draws)
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
        del whole, differentiated, leaves
        metrics = {k: v.detach() for k, v in metrics.items()}
        norm = None
        if mesh is not None:
            metrics = {k: mesh.data.all_reduce(v, "mean")
                       for k, v in metrics.items()}
            grads = {k: _reduce_grad(state, k, g) for k, g in grads.items()}
            if state.layout is not None:
                split = [k for k, d in state.layout.items() if d is not None]
                norm = lambda t: sharded_norm(t, split, mesh.data)  # noqa: E731
            elif state.tp_plan:
                norm = lambda t: sharded_norm(t, state.tp_plan, mesh.model)  # noqa: E731
        metrics["grad_norm"] = (norm(grads) if norm is not None
                                else global_norm(grads.values()))
        tx.update(grads, state.opt_state, params, norm)
        if state.ema is not None and ema_decay is not None:
            ema_update(state.ema, params, ema_decay)
        state.step += 1
        return state, metrics

    return step


# ------------------------------------------------------------- mesh helpers


def shard_batch(mesh, batch: dict) -> dict:
    """This rank's rows of a global batch (the data axis must divide it);
    a mesh step takes the global batch and draws and does this itself."""
    share = mesh.data_share(len(next(iter(batch.values()))))
    return {k: v[share] for k, v in batch.items()}


def cut_leaf(state: TrainState, key: str, v: torch.Tensor) -> torch.Tensor:
    """The piece of the whole leaf ``v`` that this rank holds under the
    state's placement, a tensor of its own (ZeRO-3's with ``v``'s memory
    order); ``v`` itself where the leaf is whole."""
    mesh = state.mesh
    if state.layout is not None and state.layout.get(key) is not None:
        dim, comm = state.layout[key], mesh.data
        n = v.shape[dim] // comm.size
        return v.narrow(dim, comm.index * n, n).clone()
    if state.tp_plan and key in state.tp_plan:
        return state.tp_plan[key].piece(v, mesh.model.index).contiguous()
    return v


def _join(state: TrainState, key: str, v: torch.Tensor) -> torch.Tensor:
    """The whole leaf from every rank's piece ``v`` (a collective: every
    rank of the group calls it), with the memory order it had before the
    split."""
    mesh = state.mesh
    if state.layout is not None and state.layout.get(key) is not None:
        shape, stride = state.whole[key]
        whole = torch.empty_strided(shape, stride, dtype=v.dtype,
                                    device=v.device)
        whole.copy_(mesh.data.all_gather(v, state.layout[key]))
        return whole
    if state.tp_plan and key in state.tp_plan:
        split = state.tp_plan[key]
        return split.join(mesh.model.all_gather(v, split.dim))
    return v


def _reduce_grad(state: TrainState, key: str, g: torch.Tensor) -> torch.Tensor:
    """A gradient averaged over the data group: all-reduced, or (ZeRO-3)
    reduce-scattered onto this rank's piece, in the memory order the piece
    of ``g`` has (so that one rank's sums run as the one-process step's)."""
    comm = state.mesh.data
    dim = None if state.layout is None else state.layout.get(key)
    if dim is None:
        return comm.all_reduce(g, "mean")
    out = torch.empty_like(g.narrow(dim, 0, g.shape[dim] // comm.size))
    out.copy_(comm.reduce_scatter(g, dim, "mean"))
    return out


def gather_params(state: TrainState) -> dict:
    """A ZeRO-3 state's parameters whole (every rank of the data group
    calls it)."""
    return with_leaves(state.params, {k: _join(state, k, v) for k, v in
                                      flatten(state.params).items()})


def _place(state: TrainState, cut: Callable) -> None:
    """Replace every tensor of the state by ``cut(state, flat key,
    tensor)``, in the params' tree, the moments (and accumulator) and the
    EMA."""
    flat = flatten(state.params)

    def each(tree):
        return {k: cut(state, k, v) for k, v in tree.items()}

    state.params = with_leaves(state.params, each(flat))
    for name in ("mu", "nu", "acc"):
        if name in state.opt_state:
            state.opt_state[name] = each(state.opt_state[name])
    if state.ema is not None:
        state.ema = each(state.ema)


def replicate_state(mesh, state: TrainState, *, tensor_parallel: bool = False,
                    models: Optional[Dict[str, torch.nn.Module]] = None
                    ) -> TrainState:
    """Place a whole train state on ``mesh`` for data parallelism: every
    rank keeps it whole (each rank built the same one). With
    ``tensor_parallel``, ``models`` (``{family: module}``, the loss's own
    modules: ``loss_fn.models``) are made tensor-parallel over the model
    group in place (``parallel.mesh.shard_model``) and every leaf they
    split is cut to this rank's piece, its moments and EMA with it."""
    state.mesh = mesh
    if not tensor_parallel or mesh.tp is None:
        return state
    if models is None:
        raise ValueError("tensor_parallel=True needs the loss's models "
                         "(models=loss_fn.models) to split them")
    state.tp_plan = {f"{family}/{k}": s for family, m in models.items()
                     for k, s in shard_model(m, mesh.tp).items()}
    _place(state, cut_leaf)
    return state


def fsdp_state(mesh, state: TrainState):
    """Place a whole train state FULLY SHARDED (ZeRO-3) over the mesh's
    data group: every leaf of at least ``parallel.mesh.FSDP_MIN_LEAF``
    elements keeps 1/N of its parameters, moments and EMA on each rank,
    along its largest divisible dim; the smaller ones stay whole. Returns
    ``(state, layout)`` ({flat leaf: split dim or None}); the step keeps
    the layout. ZeRO-3 does not combine with tensor parallelism here."""
    if mesh.tp is not None:
        raise ValueError("fsdp_state on a mesh with a model axis > 1: ZeRO-3 "
                         "splits over the data axis only")
    flat = flatten(state.params)
    state.mesh, state.layout = mesh, fsdp_layout(flat, mesh.data.size)
    state.whole = {k: (tuple(v.shape), v.stride()) for k, v in flat.items()}
    _place(state, cut_leaf)
    return state, state.layout


def gather_state(state: TrainState) -> TrainState:
    """A placed state whole, as one process holds it (every rank of the
    mesh calls it; the state itself is not changed): ZeRO-3's pieces
    gathered over the data group, tensor-parallel pieces over the model
    group."""
    if state.mesh is None or (state.layout is None and not state.tp_plan):
        return state
    out = dataclasses.replace(state, opt_state=dict(state.opt_state))
    _place(out, _join)
    return TrainState(out.step, out.params, out.opt_state, out.ema)


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], params: dict,
               decay: float) -> None:
    """``e * d + p * (1 - d)`` in place for every leaf, d and 1 - d in fp32
    as the JAX step's ``jnp.float32(ema_decay)``."""
    d = np.float32(decay)
    d, rest = float(d), float(np.float32(1.0) - d)
    flat = flatten(params)
    for k, e in ema.items():
        e.copy_(e * d + flat[k] * rest)


def with_leaves(params: dict, leaves: Dict[str, torch.Tensor],
                prefix: str = "") -> dict:
    """``params`` with the tensors at ``leaves``' (``flatten``) keys
    replaced."""
    out = {}
    for k, v in params.items():
        key = prefix + k
        out[k] = (with_leaves(v, leaves, key + "/") if isinstance(v, dict)
                  else leaves.get(key, v))
    return out
