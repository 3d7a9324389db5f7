"""The train step: optimizer, freezing labels, accumulation, EMA; the JAX
package's ``train/step.py`` on one device (its data-parallel and ZeRO-3
placement, ``replicate_state`` / ``fsdp_state``, is ROADMAP A18).

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
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

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
               params: dict) -> None:
        """One call with ``grads`` (flat, the trained leaves at least):
        updates ``params`` and ``state`` in place."""
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
            g_norm = global_norm(g.values())
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
        families = getattr(loss_fn, "families", None)
        params = state.params
        differentiated = flatten(
            params if families is None
            else {f: params[f] for f in families if f in params})
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in differentiated.items()}
        with torch.enable_grad():  # whatever the caller's grad mode
            loss, metrics = loss_fn(with_leaves(params, leaves), batch, draws)
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = global_norm(grads.values())
        tx.update(grads, state.opt_state, params)
        if state.ema is not None and ema_decay is not None:
            ema_update(state.ema, params, ema_decay)
        state.step += 1
        return state, metrics

    return step


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
