"""Sequence parallelism: one canvas's latent rows split over the ranks of a
data group (the port of the JAX package's ``ring_context`` and of what
GSPMD inserts for it).

The JAX package shards the rows of one huge canvas over its mesh's data
axis and lets GSPMD add the convolutions' halo exchanges and the
GroupNorms' cross-shard reductions, while long self-attention rides the
ring (``powerpaint_tpu/ops/ring_attention.py``). The port has no GSPMD, so
each mechanism is written out at the op layer, and every model inherits
it without edits of its own:

- ``row_context(comm, min_seq)`` (the counterpart of ``ring_context``):
  while it is active on a thread, every (B, h, W, C) activation the ops
  see holds this rank's rows ``[index * h, (index + 1) * h)`` of a canvas
  of ``size * h`` rows;
- convolutions take halo rows from the neighbouring ranks
  (``with_halo`` for the hand kernels, ``conv_rows`` for the convs that
  stay on cuDNN; ``ops.conv``, ``models.layers``);
- GroupNorm statistics are merged over the ranks (``ops.norms``);
- self-attention whose whole sequence is at least ``min_seq`` tokens rides
  the ring, shorter self-attention gathers K and V (``ops.attention``);
- FreeU's Fourier filter gathers the skip (``ops.freeu``).

A choice that reads a shape reads the canvas's (``global_rows``), as the
JAX model is traced at the global shape. Every level of the latent pyramid
must split evenly over the ranks (``check_height``).

Imports torch and the port's validation alone, so the ops can import it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from powerpaint_tpu_torch.core.validation import InputValidationError

_STATE = threading.local()


@dataclasses.dataclass(frozen=True)
class Rows:
    """The active row context: the data group's ``comm``
    (``parallel.collectives.Comm``), whose index is this rank's place down
    the canvas, and the ring's threshold ``min_seq`` (whole-canvas
    tokens)."""

    comm: object
    min_seq: int

    @property
    def size(self) -> int:
        return self.comm.size


@contextlib.contextmanager
def row_context(comm, min_seq: int = 2048):
    """Run the ops on this rank's rows of one canvas split over ``comm``
    (see the module's docstring) while the block runs on this thread."""
    prev = getattr(_STATE, "rows", None)
    _STATE.rows = Rows(comm, int(min_seq))
    try:
        yield _STATE.rows
    finally:
        _STATE.rows = prev


def current() -> Optional[Rows]:
    """The active row context of this thread, or None."""
    return getattr(_STATE, "rows", None)


def global_rows(h: int) -> int:
    """The canvas's rows at a level where this rank holds ``h`` (``h``
    outside a row context)."""
    rows = current()
    return h if rows is None else h * rows.size


def share_rows(x, comm, dim: int = 1):
    """This rank's rows of ``x`` (a tensor or array, whole along ``dim``):
    the ``comm.index``-th of ``comm.size`` equal pieces."""
    n = comm.size
    if x.shape[dim] % n:
        raise ValueError(f"{x.shape[dim]} rows (dim {dim} of "
                         f"{tuple(x.shape)}) do not split over {n} ranks")
    per = x.shape[dim] // n
    index = [slice(None)] * x.ndim
    index[dim] = slice(comm.index * per, (comm.index + 1) * per)
    return x[tuple(index)]


def check_height(h_img: int, n: int, n_levels: int) -> None:
    """Refuse an image height whose latent pyramid of ``n_levels`` levels
    does not split evenly over ``n`` ranks at every level, with the JAX
    package's message (its pipelines' check of the deepest level)."""
    deepest = (h_img // 8) >> (n_levels - 1)
    if (h_img // 8) % (n << (n_levels - 1)) or h_img % 8:
        raise InputValidationError(
            f"sequence_parallel: image height {h_img} gives a "
            f"deepest latent level of {deepest} rows, not divisible "
            f"by the {n}-way mesh axis; use a multiple of "
            f"{8 * (1 << (n_levels - 1)) * n}")


# ---------------------------------------------------------------------------
# halo rows
# ---------------------------------------------------------------------------


def extend_rows(x: torch.Tensor, top: int, bottom: int,
                edge_zeros: bool) -> Tuple[torch.Tensor, int, int]:
    """(x with ``top`` rows of the rank above and ``bottom`` rows of the
    rank below along dim 1, the rows added above, the rows added below).
    At the canvas's edge (the first rank's top, the last rank's bottom)
    ``edge_zeros`` adds zero rows, the padding of a conv that pads the
    input; otherwise none."""
    comm = current().comm
    above, below = comm.halo_rows(x, top, bottom)
    shape = lambda k: (x.shape[0], k) + tuple(x.shape[2:])  # noqa: E731
    if above is None and top and edge_zeros:
        above = x.new_zeros(shape(top))
    if below is None and bottom and edge_zeros:
        below = x.new_zeros(shape(bottom))
    parts = [t for t in (above, x, below) if t is not None]
    added_top = 0 if above is None else above.shape[1]
    added_bottom = 0 if below is None else below.shape[1]
    return (torch.cat(parts, 1) if len(parts) > 1 else x), added_top, added_bottom


def with_halo(x: torch.Tensor, fn: Callable[[torch.Tensor], torch.Tensor]
              ) -> torch.Tensor:
    """A 3x3 stride-1 SAME conv ``fn`` (a hand kernel, which pads its input
    with zeros after any prologue) on this rank's rows: x gains one row of
    each neighbour, ``fn`` runs on it, and the output rows of the added
    rows are dropped. At the canvas's edge the kernel's own padding
    applies."""
    xe, top, bottom = extend_rows(x, 1, 1, edge_zeros=False)
    if not top and not bottom:
        return fn(x)
    y = fn(xe.contiguous())
    return y[:, top:y.shape[1] - bottom].contiguous()


def conv_rows(x: torch.Tensor, conv, pad_top: int,
              pad_bottom: int) -> torch.Tensor:
    """``conv`` (an ``nn.Conv2d`` over NHWC ``x``'s NCHW view) on this
    rank's rows, as if the canvas were padded by ``pad_top`` rows above
    and ``pad_bottom`` below (its width padding is the conv's own): the
    rows it reads across the split come from the neighbours (``pad_top``
    above, kernel - stride - ``pad_top`` below), zeros at the canvas's
    edge, and the conv runs unpadded in height. Each rank's rows must be a
    multiple of the stride; the output holds this rank's rows of the
    canvas's output."""
    kh, sh = conv.kernel_size[0], conv.stride[0]
    bottom = kh - sh - pad_top
    if x.shape[1] % sh or not 0 <= bottom <= pad_bottom:
        raise ValueError(f"a {kh}x{conv.kernel_size[1]} stride-{sh} conv "
                         f"over {x.shape[1]} rows a rank")
    xe, _, _ = extend_rows(x, pad_top, bottom, edge_zeros=True)
    y = F.conv2d(xe.permute(0, 3, 1, 2), conv.weight, conv.bias,
                 stride=conv.stride, padding=(0, conv.padding[1]),
                 dilation=conv.dilation, groups=conv.groups)
    return y.permute(0, 2, 3, 1)
