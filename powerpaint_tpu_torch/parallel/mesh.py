"""The device mesh, and the tensor-parallel and ZeRO-3 placement rules (the
port of ``powerpaint_tpu/parallel/mesh.py``).

The JAX package lays a (data, model) mesh over its devices and lets GSPMD
insert the collectives. The port runs one process per rank over a
``torch.distributed`` default group, and its modules call the collectives
themselves (``parallel.collectives``):

- axis "data": the image batch (pipelines) or the train batch is split
  over the ranks of a model column; each rank runs its share and the
  results are all-gathered, or the gradients averaged;
- axis "model": tensor parallelism over the attention heads and the MLP
  hidden dim of every transformer block and CLIP layer: q/k/v, GEGLU's
  ``proj`` and ``fc1`` column-parallel, ``to_out.0`` / ``out_proj`` /
  ``ff.net.2`` / ``fc2`` row-parallel (partial products summed over the
  data row, the bias added once).

Rank r of n at ``model_parallel`` tp is data index ``r // tp`` and model
index ``r % tp``: ``np.array(devices).reshape(n // tp, tp)``, as
``build_mesh`` lays out the JAX devices.

Placement departures from the JAX rules (each rank holds plain local
tensors for the hand kernels, where GSPMD can hold any split and reshard):

- a module whose heads (or hidden width) the model axis does not divide
  stays whole on every rank: the VAE's one-head mid attention, CLIP-L's 12
  heads at tp = 8; JAX splits such a leaf and lets GSPMD fix the
  contraction;
- the IP-Adapter's ``to_k_ip`` / ``to_v_ip`` split by heads like ``to_k``
  / ``to_v`` (JAX keeps them replicated: its queries are whole, the
  port's local);
- GEGLU's ``proj`` (h and gate stacked, ``chunk(2)``) gives each rank the
  same rows of h and of the gate, not a contiguous block of the stack.
"""

from __future__ import annotations

import dataclasses
import logging
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from powerpaint_tpu_torch.models.clip_text import CLIPAttention, CLIPMLP
from powerpaint_tpu_torch.models.transformer import Attention, FeedForward
from powerpaint_tpu_torch.parallel.collectives import Comm

DATA_AXIS = "data"
MODEL_AXIS = "model"
FSDP_MIN_LEAF = 2 ** 14

log = logging.getLogger("powerpaint_tpu_torch.parallel")


# ---------------------------------------------------------------------------
# backend and mesh
# ---------------------------------------------------------------------------


def choose_backend(devices: Sequence, backend: Optional[str] = None) -> str:
    """The process group's backend for ranks on ``devices`` (one per rank):
    NCCL where every rank has a card of its own, gloo for CPU ranks or when
    asked for. Refuses what cannot run; never substitutes one for the
    other."""
    devs = [torch.device(d) for d in devices]
    kinds = {d.type for d in devs}
    if kinds - {"cpu", "cuda"} or len(kinds) > 1:
        raise ValueError(f"ranks on {sorted(str(d) for d in devs)}: every "
                         "rank on the CPU, or every rank on a card")
    cuda = kinds == {"cuda"}
    cards = [d.index if d.index is not None else 0 for d in devs]
    shared = cuda and len(set(cards)) < len(cards)
    if backend is None:
        if cuda and shared:
            raise ValueError(
                f"{len(cards)} ranks on {len(set(cards))} card(s): NCCL "
                "refuses two ranks on one card; ask for backend='gloo'")
        return "nccl" if cuda else "gloo"
    if backend == "nccl":
        if not cuda:
            raise ValueError("NCCL needs every rank on a card")
        if shared:
            raise ValueError(
                f"{len(cards)} ranks on {len(set(cards))} card(s): NCCL "
                "refuses two ranks on one card; ask for backend='gloo'")
        return backend
    if backend == "gloo":
        return backend
    raise ValueError(f"unknown backend {backend!r}: 'nccl' or 'gloo'")


@dataclasses.dataclass
class Mesh:
    """This rank's place in a (data, model) mesh over the default process
    group: its coordinates, its device, and the two subgroups it belongs
    to, ``data`` (the ranks of its model column, which split the batch) and
    ``model`` (the ranks of its data row, which split the weights)."""

    rank: int
    data_index: int
    model_index: int
    device: torch.device
    backend: str
    data: Comm
    model: Comm

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data.size, MODEL_AXIS: self.model.size}

    @property
    def tp(self) -> Optional[Comm]:
        """The model group where the weights are split (None at tp = 1)."""
        return self.model if self.model.size > 1 else None

    def data_share(self, b: int) -> slice:
        """This rank's rows of a batch of ``b``: the data axis must divide
        it (the JAX pipeline's batch sharding refuses any other)."""
        n = self.data.size
        if b % n:
            raise ValueError(
                f"a batch of {b} does not split over the {n}-way data axis: "
                f"use a multiple of {n} images")
        per = b // n
        return slice(self.data_index * per, (self.data_index + 1) * per)


def build_mesh(devices: Optional[Sequence] = None, model_parallel: int = 1,
               backend: Optional[str] = None) -> Mesh:
    """The mesh of the initialised default group: ``devices`` one per rank
    in rank order (default: each rank's current card, or the CPU), laid out
    (n // tp, tp). Every rank calls it with the same arguments (it creates
    the subgroups, a collective call)."""
    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs an initialised default process "
                           "group (parallel.launch.spawn starts the ranks)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if devices is None:
        devices = (["cuda:%d" % i for i in range(world)]
                   if dist.get_backend() == "nccl" else ["cpu"] * world)
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by tp={model_parallel}")
    if n != world:
        raise ValueError(f"{n} devices for a world of {world} ranks")
    chosen = choose_backend(devices, backend or dist.get_backend())
    if chosen != dist.get_backend():
        raise ValueError(f"the default group runs {dist.get_backend()}, the "
                         f"mesh asks for {chosen}")
    tp = model_parallel
    grid = np.arange(n).reshape(n // tp, tp)
    rows = [list(map(int, r)) for r in grid]  # one model group per data row
    cols = [list(map(int, c)) for c in grid.T]  # one data group per column
    device = devices[rank]
    data = model = None
    for ranks in cols:
        g = dist.new_group(ranks, backend=chosen)
        if rank in ranks:
            data = Comm(g, ranks, ranks.index(rank), chosen, device)
    for ranks in rows:
        g = dist.new_group(ranks, backend=chosen)
        if rank in ranks:
            model = Comm(g, ranks, ranks.index(rank), chosen, device)
    mesh = Mesh(rank, rank // tp, rank % tp, device, chosen, data, model)
    if rank == 0:
        log.info("mesh %s over %s on %s", mesh.shape, chosen,
                 sorted({str(d) for d in devices}))
    return mesh


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------

# The JAX package's _PARAM_RULES in the port's names: (pattern, dim) with
# dim 0 the output features of a torch Linear weight (column-parallel) and
# dim 1 its input features (row-parallel, bias whole and added once).
PARAM_RULES: Tuple[Tuple[str, int], ...] = (
    (r"(.*\.)?(to_q|to_k|to_v)\.weight$", 0),
    (r"(.*\.)?(q_proj|k_proj|v_proj)\.weight$", 0),
    (r"(.*\.)?ff\.net\.0\.proj\.weight$", 0),
    (r"(.*\.)?fc1\.weight$", 0),
    (r"(.*\.)?to_out\.0\.weight$", 1),
    (r"(.*\.)?out_proj\.weight$", 1),
    (r"(.*\.)?ff\.net\.2\.weight$", 1),
    (r"(.*\.)?fc2\.weight$", 1),
    (r"(.*\.)?(to_q|to_k|to_v|q_proj|k_proj|v_proj)\.bias$", 0),
    (r"(.*\.)?ff\.net\.0\.proj\.bias$", 0),
    (r"(.*\.)?fc1\.bias$", 0),
)


def param_spec(name: str) -> Optional[int]:
    """The rule table: the split dim of the parameter ``name`` (a state
    dict key), or None for whole. First match wins, as in JAX."""
    for pattern, dim in PARAM_RULES:
        if re.match(pattern, name):
            return dim
    return None


@dataclasses.dataclass(frozen=True)
class Split:
    """How one tensor is cut over the model group: along ``dim`` into
    ``size`` equal pieces; ``halves`` cuts each half of the dim apart and
    takes the same piece of both (GEGLU's stacked h and gate)."""

    dim: int
    size: int
    halves: bool = False

    def piece(self, full: torch.Tensor, index: int) -> torch.Tensor:
        if self.halves:
            return torch.cat([h.chunk(self.size, self.dim)[index]
                              for h in full.chunk(2, self.dim)], self.dim)
        return full.chunk(self.size, self.dim)[index]

    def join(self, gathered: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's piece concatenated along
        ``dim`` in rank order (``Comm.all_gather``)."""
        if not self.halves:
            return gathered
        parts = gathered.chunk(2 * self.size, self.dim)
        return torch.cat(parts[0::2] + parts[1::2], self.dim)

    def whole(self, piece_shape: Sequence[int]) -> Tuple[int, ...]:
        shape = list(piece_shape)
        shape[self.dim] *= self.size
        return tuple(shape)


def _tp_modules(model: nn.Module, tp: int) -> List[Tuple[str, nn.Module]]:
    """(name, module) of every module the model axis splits: the
    transformer ``Attention`` / ``FeedForward`` and the CLIP attention /
    MLP whose heads (hidden width) ``tp`` divides."""
    out = []
    for name, m in model.named_modules():
        if isinstance(m, (Attention, CLIPAttention)) and m.num_heads % tp == 0:
            out.append((name, m))
        elif isinstance(m, FeedForward) and m.net[2].in_features % tp == 0:
            out.append((name, m))
        elif isinstance(m, CLIPMLP) and m.fc1.out_features % tp == 0:
            out.append((name, m))
    return out


def tp_plan(model: nn.Module, tp: int) -> Dict[str, Split]:
    """{parameter name: Split} of every parameter the model axis of size
    ``tp`` cuts in ``model`` (names as in its state dict)."""
    plan = {}
    if tp <= 1:
        return plan
    for prefix, m in _tp_modules(model, tp):
        pre = prefix + "." if prefix else ""
        for pname, _ in m.named_parameters():
            full = pre + pname
            if pname.startswith(("to_k_ip.", "to_v_ip.")):
                plan[full] = Split(0, tp)  # by heads, as to_k / to_v
                continue
            ff = isinstance(m, FeedForward)  # "ff" in every block
            dim = param_spec(("ff." if ff else "") + pname)
            if dim is None:
                continue
            halves = ff and pname.startswith("net.0.")
            plan[full] = Split(dim, tp, halves)
    return plan


def shard_state(state: dict, plan: Dict[str, Split], index: int) -> dict:
    """``state`` with every planned tensor cut to this rank's piece (a
    contiguous copy), the rest as they are."""
    out = {}
    for k, v in state.items():
        if k in plan:
            t = v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
            v = plan[k].piece(t, index).contiguous()
        out[k] = v
    return out


def shard_model(model: nn.Module, comm: Comm) -> Dict[str, Split]:
    """Make ``model`` tensor-parallel over ``comm`` in place: every split
    module learns its group (``tp``) and its local head count, and every
    planned parameter becomes this rank's piece (on the meta device, a
    meta tensor of the piece's shape). Returns the plan; each split linear
    keeps its ``Split`` as ``tp_split`` (LoRA deltas are cut by it). A
    model already split over ``comm`` is left as it is (its plan
    returned); over another group, refused."""
    done = getattr(model, "tp_done", None)
    if done is not None:
        if done[0] is not comm:
            raise ValueError("the model is already split over another "
                             "model group")
        return done[1]
    plan = tp_plan(model, comm.size)
    for _, m in _tp_modules(model, comm.size):
        m.tp = comm
        if hasattr(m, "num_heads"):
            m.num_heads //= comm.size
    for name, split in plan.items():
        mod_name, pname = name.rsplit(".", 1)
        mod = model.get_submodule(mod_name)
        p = getattr(mod, pname)
        piece = split.piece(p.detach(), comm.index).contiguous()
        setattr(mod, pname, nn.Parameter(piece, requires_grad=p.requires_grad))
        if pname == "weight":
            mod.tp_split = (split, comm.index)
    model.tp_done = (comm, plan)
    return plan


def local_piece(module: nn.Module, full: torch.Tensor) -> torch.Tensor:
    """``full`` (a tensor of the whole weight's shape) cut as ``module``'s
    weight is: itself where the module is not split."""
    cut = getattr(module, "tp_split", None)
    if cut is None:
        return full
    split, index = cut
    return split.piece(full, index)


def whole_shape(module: nn.Module) -> Tuple[int, ...]:
    """The shape of ``module``'s weight before any tensor-parallel cut."""
    cut = getattr(module, "tp_split", None)
    shape = tuple(module.weight.shape)
    return shape if cut is None else cut[0].whole(shape)


# ---------------------------------------------------------------------------
# ZeRO-3
# ---------------------------------------------------------------------------


def fsdp_dim(shape: Sequence[int], n: int) -> Optional[int]:
    """The dim a leaf of ``shape`` splits along over an ``n``-way data axis
    (JAX ``fsdp_shardings``): its largest dim that ``n`` divides, for a
    leaf of at least ``FSDP_MIN_LEAF`` elements; None (replicated) for a
    smaller leaf or one with no such dim. Ties go to the LEADING dim, the
    output features of the port's OIHW / (out, in) layouts (JAX's go to
    the trailing one, the output features of its HWIO / (in, out))."""
    if int(np.prod(shape, dtype=np.int64)) < FSDP_MIN_LEAF:
        return None
    best = None
    for d, size in enumerate(shape):
        if size % n == 0 and (best is None or size > shape[best]):
            best = d
    return best


def fsdp_layout(flat: Dict[str, torch.Tensor], n: int) -> Dict[str, Optional[int]]:
    """{leaf: split dim or None} of a flat tree over an ``n``-way data
    axis."""
    return {k: fsdp_dim(tuple(v.shape), n) for k, v in flat.items()}
