"""Serving micro-batcher: coalesce concurrent requests into one generate.

The port of ``powerpaint_tpu/serve/batcher.py``. The reference serializes
requests (gradio ``demo.queue()``, app.py:748). Requests that arrive
within ``window_ms`` and share the same shape and shared arguments run as
ONE multi-request call with per-request prompts, fitting degrees, guidance
scales and seeds (the pipelines' batched form). Per-image noise depends
only on each request's own seed (``pipelines.common.draw_noise``).

A batched image is not bitwise the same request alone on the card: cuBLAS
fp32 products and cuDNN's stride-2 convolutions choose their algorithm by
batch size, so the images differ up to the widest batch-vs-alone
difference ``ROADMAP.md`` Queue C records for ppt-v1 (its int8 entry: max
18, mean 2.0 uint8 levels). On the CPU they agree within 1 uint8 level.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


# per-request fields become parallel lists in the batched call; everything
# in SHARED must match for two requests to share one call
PER_REQUEST = ("prompt", "negative_prompt", "fitting_degree",
               "guidance_scale", "seed")
PER_REQUEST_DEFAULTS = {"prompt": "", "negative_prompt": "",
                        "fitting_degree": 1.0, "guidance_scale": 7.5,
                        "seed": 0}
SHARED = ("task", "num_inference_steps", "strength", "scheduler", "eta",
          "brushnet_conditioning_scale", "controlnet_conditioning_scale",
          "control_guidance_start", "control_guidance_end", "guess_mode",
          "ip_adapter_scale", "encoder_cache_interval",
          "branch_cache_interval", "clip_skip")


def _hashable(v):
    return tuple(v) if isinstance(v, list) else v


@dataclasses.dataclass
class _Pending:
    image: np.ndarray  # (H, W, 3) uint8
    mask: np.ndarray  # (H, W) float
    kwargs: Dict[str, Any]
    event: threading.Event = dataclasses.field(
        default_factory=threading.Event
    )
    result: Optional[np.ndarray] = None
    error: Optional[BaseException] = None

    def batchable(self) -> bool:
        # DDIM's eta noise and the IP-Adapter inputs are per call, not per
        # image, and given latents are the caller's own: run those alone.
        # Control requests batch with each other (per-image control stacks
        # along B; per-image seeds)
        k = self.kwargs
        return (float(k.get("eta", 0.0)) == 0.0
                and k.get("ip_adapter_image") is None
                and k.get("ip_adapter_image_embeds") is None
                and k.get("latents") is None)

    def _control_sig(self) -> Tuple:
        """Branch count + shapes: requests share a call only when their
        control topology matches (content may differ)."""
        c = self.kwargs.get("control_image")
        if c is None:
            return ("nocontrol",)
        cs = c if isinstance(c, (list, tuple)) else [c]
        return ("control", len(cs)) + tuple(
            np.asarray(x).shape for x in cs
        )

    def group_key(self) -> Tuple:
        k = self.kwargs
        return (self.image.shape,) + self._control_sig() + tuple(
            (name, _hashable(k[name])) for name in SHARED if name in k
        )


class _SyncPending:
    """Adapter for pipelines without an async ``submit`` surface: the call
    already completed synchronously; ``result()`` just hands it back."""

    def __init__(self, out):
        self._out = out

    def result(self):
        return self._out


class MicroBatcher:
    """submit() blocks until the request's image is ready.

    Only eta==0 requests batch with each other (the DDIM eta noise stream
    is keyed per call, not per image); eta>0 requests run alone.

    Request pipelining (``pipelines.async_dispatch``): the worker thread
    dispatches each batch through ``pipe.submit`` and hands the pending
    result to a fetcher thread, then at once assembles and dispatches the
    NEXT batch, so host preprocessing and the upload of request N+1 overlap
    request N's device work. ``pipeline_depth`` bounds the batches in
    flight (device output buffers).

    ``lock`` is held around every dispatch on the pipeline: the port's
    pipelines keep per-call state (telemetry stages, the callback slot, a
    per-call LoRA scale merged in place, the UNet's FreeU), so a caller
    that runs the same pipeline directly (``serve.app._BatchedPipe``'s
    multi-image requests) takes it too. ``sizes`` counts the batches
    dispatched by size.
    """

    def __init__(self, pipe, max_batch: int = 8, window_ms: float = 20.0,
                 pipeline_depth: int = 2):
        self.pipe = pipe
        self.max_batch = max_batch
        self.window_s = window_ms / 1000.0
        self.lock = threading.Lock()
        self.sizes: "collections.Counter[int]" = collections.Counter()
        self._q: "queue.Queue[_Pending]" = queue.Queue()
        # (batch, pending) pairs awaiting device completion; bounded so a
        # fast dispatcher cannot pile device buffers
        self._inflight: "queue.Queue" = queue.Queue(
            maxsize=max(1, pipeline_depth)
        )
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        self._fetcher = threading.Thread(target=self._fetch_worker,
                                         daemon=True)
        self._fetcher.start()

    def close(self):
        self._stop.set()
        self._q.put(None)  # wake the worker
        self._thread.join(timeout=60)
        if self._thread.is_alive():
            # The worker is still inside a dispatch (a first call that
            # builds the kernels). Inserting the fetcher sentinel NOW could
            # land AHEAD of that batch in _inflight, making the fetcher
            # exit before it and stranding submitters in event.wait()
            # forever. Leave both daemon threads running; they drain
            # naturally and die with the process.
            return
        # worker has exited -> nothing more will be enqueued; the sentinel
        # is guaranteed to be the last _inflight item
        self._inflight.put(None)
        self._fetcher.join(timeout=60)

    # ------------------------------------------------------------- client

    def submit(self, image: np.ndarray, mask: np.ndarray, **kwargs):
        req = _Pending(image=image, mask=mask, kwargs=kwargs)
        self._q.put(req)
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.result

    # ------------------------------------------------------------- worker

    def _collect(self, first: _Pending) -> List[_Pending]:
        batch = [first]
        if not first.batchable():
            return batch
        key = first.group_key()
        # wait up to window_s for more compatible work
        end = time.monotonic() + self.window_s
        leftovers: List[_Pending] = []
        while len(batch) < self.max_batch:
            timeout = end - time.monotonic()
            if timeout <= 0:
                break
            try:
                nxt = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if nxt is None:
                self._q.put(None)  # re-arm the stop sentinel for _worker
                break
            if nxt.batchable() and nxt.group_key() == key:
                batch.append(nxt)
            else:
                leftovers.append(nxt)
        for item in leftovers:  # requeue what we can't batch
            self._q.put(item)
        return batch

    def _worker(self):
        while not self._stop.is_set():
            first = self._q.get()
            if first is None:
                continue
            batch = self._collect(first)
            try:
                with self.lock:
                    pending = self._dispatch(batch)
                self.sizes[len(batch)] += 1
            except BaseException as e:  # propagate to every waiter
                for r in batch:
                    r.error = e
                    r.event.set()
                continue
            # hand to the fetcher; blocks only when pipeline_depth batches
            # are already executing on the device
            self._inflight.put((batch, pending))

    def _dispatch(self, batch: List[_Pending]):
        """Assemble and dispatch one batched generate; no result fetch."""
        submit = getattr(self.pipe, "submit", None)
        if len(batch) == 1:
            r = batch[0]
            if submit is None:
                return _SyncPending(self.pipe(r.image, r.mask, **r.kwargs))
            return submit(r.image, r.mask, **r.kwargs)
        k0 = batch[0].kwargs
        call = {name: k0[name] for name in SHARED if name in k0}
        for name in PER_REQUEST:
            call[name] = [
                r.kwargs.get(name, PER_REQUEST_DEFAULTS[name])
                for r in batch
            ]
        if k0.get("control_image") is not None:
            call["control_image"] = [
                r.kwargs["control_image"] for r in batch
            ]
        images = [r.image for r in batch]
        masks = [r.mask for r in batch]
        if submit is None:
            return _SyncPending(self.pipe(images, masks, **call))
        return submit(images, masks, **call)

    def _fetch_worker(self):
        while True:
            item = self._inflight.get()
            if item is None:
                return
            batch, pending = item
            try:
                out = pending.result()
                for i, r in enumerate(batch):
                    r.result = out[i]
                    r.event.set()
            except BaseException as e:
                for r in batch:
                    r.error = e
                    r.event.set()
