"""Async request pipelining: dispatch a generate without waiting on the card.

The port of ``powerpaint_tpu/pipelines/async_dispatch.py``. The reference's
serving path is strictly sequential (eager torch: every request pays
upload, compute and download end to end). ``pipe.submit(...)`` runs the
normal ``__call__`` host path (validation, tokenization, the uploads, every
kernel launch) and returns a :class:`PendingImages` once the last launch
and the copy of the result to the host are queued; ``.result()`` waits for
them. A serving loop that dispatches request N+1 before fetching request N
keeps the card busy back to back (``serve.batcher`` does this).

This works only because a call never waits on the card before its final
copy: the uploads go through pinned host memory with ``non_blocking``
copies (``pipelines.common.to_device``), per-step scalars are slices of
one per-call device tensor or made on the device, and ``finish`` copies the
result into pinned memory with ``non_blocking`` and records a
``torch.cuda.Event`` after the copy. Everything runs on the caller's
current stream, so requests keep the stream's order.

Implementation: a context variable (thread-local by construction) flips the
pipelines' shared ``finish()`` from "fetch to numpy" to "queue the copy and
hand back a PendingImages" for the duration of one dispatch, so all three
pipelines and both the single- and multi-request forms inherit the async
form without duplicating their argument plumbing.
"""

from __future__ import annotations

import contextvars
from typing import Optional

import numpy as np
import torch

_FETCH: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "powerpaint_torch_fetch_results", default=True
)


def finish(out: torch.Tensor):
    """Last step of every pipeline ``__call__``: fetch to host numpy (the
    default, which waits for the card) or, under ``submit()``, queue a
    ``non_blocking`` copy into pinned host memory, record an event after it
    and hand back a :class:`PendingImages`. A CPU tensor is complete at
    once."""
    if _FETCH.get():
        return out.cpu().numpy()
    if out.device.type != "cuda":
        return PendingImages(out, None)
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(out.device))
    return PendingImages(host, event)


class PendingImages:
    """A dispatched generate whose result has not been fetched yet."""

    __slots__ = ("_host", "_event", "_fetched")

    def __init__(self, host: torch.Tensor, event: Optional[torch.cuda.Event]):
        self._host = host
        self._event = event
        self._fetched = None

    def result(self) -> np.ndarray:
        """Wait until the card has finished the call and its copy; returns
        the same (B, H, W, 3) uint8 array the synchronous call would have."""
        if self._fetched is None:
            if self._event is None:
                self._fetched = self._host.numpy()
            else:
                self._event.synchronize()
                # out of the pinned block, which goes back to the host cache
                self._fetched = self._host.numpy().copy()
            self._host = self._event = None
        return self._fetched

    def done(self) -> bool:
        """True once the card has finished the call and its copy (does not
        wait); the array still comes from ``result()``."""
        if self._fetched is not None or self._event is None:
            return True
        return self._event.query()


class AsyncDispatchMixin:
    """Adds ``submit()`` to a pipeline whose ``__call__`` ends in
    :func:`finish`."""

    def submit(self, *args, **kwargs) -> PendingImages:
        """Same surface as ``__call__`` but returns a
        :class:`PendingImages` right after dispatch instead of blocking on
        the device->host fetch.

        Per-call step callbacks are rejected: the host trampoline reads
        the pipeline's active-callback slot at execution time, so a later
        dispatch would overwrite it while an earlier request is still
        running on device and its steps would invoke the wrong callback.
        Use the synchronous ``__call__`` for callback observation."""
        if kwargs.get("callback") is not None:
            from powerpaint_tpu_torch.core.validation import InputValidationError

            raise InputValidationError(
                "callback is not supported with submit(): in-flight "
                "requests share the callback slot; use the synchronous "
                "call for step callbacks"
            )
        token = _FETCH.set(False)
        try:
            return self(*args, **kwargs)
        finally:
            _FETCH.reset(token)
