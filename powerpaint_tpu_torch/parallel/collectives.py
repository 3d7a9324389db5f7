"""The collective layer: every ``torch.distributed`` call of the port.

A ``Comm`` is one subgroup of the mesh (a data row's model group, or a
model column's data group) with ``all_reduce``, ``all_gather`` and
``reduce_scatter``, and the two point-to-point exchanges of sequence
parallelism, ``shift`` (round the ring) and ``halo_rows`` (the edge rows
of the neighbouring ranks); ``copy_to_model`` / ``reduce_from_model`` are
Megatron's *f* / *g* pair for tensor parallelism (identity forward and
all-reduce backward, and the reverse), and ``row_parallel_linear`` is a
row-parallel linear built on *g*.

Backends (``parallel.mesh.build_mesh`` chooses; nothing here falls back):

- NCCL: tensors go to the collective as they are, on the card.
- gloo: CPU tensors go as they are. A CUDA tensor (two ranks sharing one
  card, where NCCL refuses) is staged through pinned host memory here,
  explicitly: copied down, reduced or gathered on the host, copied back
  with ``non_blocking`` (the caching host allocator holds the pinned block
  until that copy has run). The staging waits for the card. gloo's
  reduce-scatter is an all-reduce and a slice, and its gather a list
  gather, forms every torch version's gloo takes.

The point-to-point exchanges post every send and receive of a rank as one
batch (``batch_isend_irecv``), so no order of the ranks deadlocks them.

Reductions run in fp32 whatever the input type (a bf16 sum rounds at
every addition, which the one-device path does not), and the result comes
back in the input's type; gathers move the values as they are.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

# every torch version the port meets accepts this name (newer ones add an
# alias, ``reduce_scatter_single``, and warn on the old one)
_reduce_scatter_tensor = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor

# copies through pinned host memory this process has made (gloo ranks on a
# card), down and up, and their bytes: what a call costs in staging
STAGED = {"copies": 0, "bytes": 0}


class Comm:
    """One process subgroup: ``ranks`` (global ranks, in the group's order),
    this process's ``index`` in it, the ``backend`` and the rank's
    ``device``. ``group`` is the ``torch.distributed`` group handle."""

    def __init__(self, group, ranks: Sequence[int], index: int, backend: str,
                 device: torch.device):
        self.group = group
        self.ranks = tuple(ranks)
        self.index = index
        self.size = len(self.ranks)
        self.backend = backend
        self.device = torch.device(device)

    # ------------------------------------------------------------ staging

    def _staged(self, x: torch.Tensor) -> bool:
        return self.backend == "gloo" and x.device.type == "cuda"

    @staticmethod
    def _down(x: torch.Tensor) -> torch.Tensor:
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        STAGED["copies"] += 1
        STAGED["bytes"] += host.numel() * host.element_size()
        return host

    @staticmethod
    def _up(host: torch.Tensor, device: torch.device) -> torch.Tensor:
        STAGED["copies"] += 1
        STAGED["bytes"] += host.numel() * host.element_size()
        return host.to(device, non_blocking=True)

    # ------------------------------------------------------------ operations

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The elementwise sum ("sum") or mean ("mean") of ``x`` over the
        group, summed in fp32, as a new tensor of ``x``'s type and memory
        order (a channels-last gradient stays channels-last, so what sums
        it afterwards runs as on the tensor before)."""
        y = torch.empty_like(x, dtype=torch.float32)  # x's dense strides
        y.copy_(x.detach())
        flat = y.as_strided((y.numel(),), (1,))  # its memory, in order
        if self._staged(flat):
            host = self._down(flat)
            dist.all_reduce(host, group=self.group)
            flat.copy_(host)
            STAGED["copies"] += 1
            STAGED["bytes"] += host.numel() * host.element_size()
        else:
            dist.all_reduce(flat, group=self.group)
        if op == "mean":
            y = y / self.size
        elif op != "sum":
            raise ValueError(f"unknown reduction {op!r}")
        return y.to(x.dtype)

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in group order
        (each rank's piece the same shape); the bits as sent."""
        moved = x.detach().movedim(dim, 0).contiguous()
        if self.backend == "gloo":
            src = self._down(moved) if self._staged(moved) else moved
            pieces = [torch.empty_like(src) for _ in range(self.size)]
            dist.all_gather(pieces, src, group=self.group)
            out = torch.cat(pieces)
            if self._staged(moved):
                out = self._up(out, x.device)
        else:
            out = torch.empty((self.size * moved.shape[0],) + moved.shape[1:],
                              dtype=moved.dtype, device=moved.device)
            dist.all_gather_into_tensor(out, moved, group=self.group)
        return out.movedim(0, dim)

    def _exchange(self, sends, recvs, device) -> list:
        """Point to point: ``sends`` [(tensor, group index)] go out and
        ``recvs`` [(shape, dtype, group index)] come in, all posted as one
        batch; returns the received tensors on ``device``, in order."""
        staged = self.backend == "gloo" and torch.device(device).type == "cuda"
        ops, got = [], []
        for x, peer in sends:
            x = x.detach().contiguous()
            x = self._down(x) if staged else x
            ops.append(dist.P2POp(dist.isend, x, self.ranks[peer], self.group))
        for shape, dtype, peer in recvs:
            buf = (torch.empty(shape, dtype=dtype, pin_memory=True) if staged
                   else torch.empty(shape, dtype=dtype, device=device))
            ops.append(dist.P2POp(dist.irecv, buf, self.ranks[peer], self.group))
            got.append(buf)
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return [self._up(t, device) for t in got] if staged else got

    def shift(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` of the previous rank of the ring (index - 1, the last
        rank's on the first): every rank sends its ``x`` to index + 1, as
        ``jax.lax.ppermute`` with the ring permutation. Every rank's ``x``
        has one shape and type."""
        if self.size == 1:
            return x
        nxt, prev = (self.index + 1) % self.size, (self.index - 1) % self.size
        return self._exchange([(x, nxt)], [(x.shape, x.dtype, prev)],
                              x.device)[0]

    def halo_rows(self, x: torch.Tensor, up: int, down: int):
        """(above, below): the last ``up`` rows (dim 1) of the rank before
        this one and the first ``down`` rows of the rank after it, for a
        (B, h, ...) tensor whose rows are split over the group in index
        order; None where there is no such rank (the first rank gets
        nothing above, the last nothing below) or no row is asked for."""
        i, n = self.index, self.size
        sends, recvs, which = [], [], []
        if up and i + 1 < n:
            sends.append((x[:, x.shape[1] - up:], i + 1))
        if down and i > 0:
            sends.append((x[:, :down], i - 1))
        for rows, peer, name in ((up, i - 1, "above"), (down, i + 1, "below")):
            if rows and 0 <= peer < n:
                recvs.append(((x.shape[0], rows) + tuple(x.shape[2:]),
                              x.dtype, peer))
                which.append(name)
        got = dict(zip(which, self._exchange(sends, recvs, x.device)))
        return got.get("above"), got.get("below")

    def reduce_scatter(self, x: torch.Tensor, dim: int = 0,
                       op: str = "sum") -> torch.Tensor:
        """This rank's piece (``index``-th of ``size`` equal ones along
        ``dim``) of the group's elementwise sum or mean, summed in fp32."""
        if x.shape[dim] % self.size:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over {self.size} ranks")
        if self.backend == "gloo":
            full = self.all_reduce(x, op)
            return full.chunk(self.size, dim)[self.index].contiguous()
        moved = x.detach().movedim(dim, 0).to(torch.float32).contiguous()
        out = torch.empty((moved.shape[0] // self.size,) + moved.shape[1:],
                          dtype=torch.float32, device=moved.device)
        _reduce_scatter_tensor(out, moved, group=self.group)
        if op == "mean":
            out = out / self.size
        elif op != "sum":
            raise ValueError(f"unknown reduction {op!r}")
        return out.to(x.dtype).movedim(0, dim).contiguous()


# ---------------------------------------------------------------------------
# tensor parallelism: Megatron's f and g
# ---------------------------------------------------------------------------


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        return comm.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """*f*: ``x`` as it is; its gradient all-reduced over the model group
    (the input of a column-parallel layer, used by every rank's shard)."""
    return _CopyToModel.apply(x, comm)


def reduce_from_model(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """*g*: the sum of ``x`` over the model group; its gradient as it is
    (the partial outputs of a row-parallel layer)."""
    return _ReduceFromModel.apply(x, comm)


def row_parallel_linear(linear: nn.Linear, x: torch.Tensor,
                        comm: Comm) -> torch.Tensor:
    """A linear whose weight holds this rank's columns (input features):
    the partial product in fp32 (a bf16 product would round each rank's
    partial sum, which the whole product does not), summed over the model
    group in fp32, then the whole bias added once and one rounding to
    ``x``'s type, as the whole product's fp32 accumulator is rounded once."""
    part = F.linear(x.float(), linear.weight.float())
    y = reduce_from_model(part, comm)
    if linear.bias is not None:
        y = y + linear.bias.float()
    return y.to(x.dtype)
