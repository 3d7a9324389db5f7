"""Training batch construction (host-side): the JAX package's
``train/data.py``, batch for batch.

Mirrors the PowerPaint training recipe (arXiv 2312.03594 §4): every sample
is (image, mask, task) with the task deciding both the mask distribution
(train/masks.py) and the prompt the model sees — built with the SAME
task-token construction the inference pipelines use (text/prompts.add_task,
reference app.py:37-64), so the learned P_ctxt/P_shape/P_obj rows are
trained against exactly the strings they are sampled with.

Classifier-free-guidance dropout replaces the prompt with the empty string
on a fraction of samples (the SD convention the reference's CFG math
assumes).

Sources:
- ``SyntheticSource``: procedural images + captions (tests and smoke runs,
  which need no dataset).
- ``FolderSource``: a directory of images with optional ``<stem>.txt``
  captions (the practical fine-tuning path).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from powerpaint_tpu_torch.text.prompts import add_task, v2_prompt_suffix
from powerpaint_tpu_torch.train.masks import random_mask

TASKS = ("text-guided", "object-removal", "shape-guided",
         "image-outpainting")
_TASK_MASK_KIND = {
    "text-guided": None,  # any
    "object-removal": "mix",
    "shape-guided": "rect",
    "image-outpainting": "border",
}


def build_prompt_ids(
    tokenizer, caption: str, task: str, version: str = "ppt-v1",
    *, dropped: bool = False,
) -> np.ndarray:
    """(77,) ids for the TRAINING prompt of ``task``: the task-token
    positive prompt A (fitting-degree-1 side) built from the caption; CFG
    dropout replaces the caption but keeps the task tokens (the model must
    learn the task semantics even for the uncond branch it will see at
    inference through the negative prompt)."""
    cap = "" if dropped else caption
    p = add_task(cap, "", task, version)
    return np.asarray(tokenizer([p.promptA])[0])


def build_v2_prompt_ids(
    tokenizer, caption: str, task: str, *, dropped: bool = False
) -> Dict[str, np.ndarray]:
    """v2 trains the BrushNet branch on task-token prompts while the frozen
    base sees the plain caption (the pipeline's asymmetric conditioning,
    reference pipeline_PowerPaint_Brushnet_CA.py:1252-1268)."""
    cap = "" if dropped else caption
    p = add_task(v2_prompt_suffix(cap, task), "", task, "ppt-v2")
    return {
        "ids": np.asarray(tokenizer([p.promptA])[0]),
        "ids_plain": np.asarray(tokenizer([p.promptU])[0]),
    }


@dataclasses.dataclass
class SyntheticSource:
    """Procedural (image, caption) pairs: colored gradient backgrounds with
    a colored shape, captioned from a tiny grammar."""

    hw: int = 64
    seed: int = 0

    _COLORS = ("red", "green", "blue", "yellow")
    _SHAPES = ("ball", "box")

    def __iter__(self):
        rng = np.random.RandomState(self.seed)
        h = w = self.hw
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        while True:
            base = np.stack([
                yy / h * rng.rand(), xx / w * rng.rand(),
                np.full_like(yy, rng.rand()),
            ], -1)
            ci = rng.randint(len(self._COLORS))
            si = rng.randint(len(self._SHAPES))
            col = np.eye(3)[ci % 3] * 0.9 + 0.1
            cy, cx = rng.randint(h // 4, 3 * h // 4), rng.randint(
                w // 4, 3 * w // 4)
            r = rng.randint(h // 8, h // 4)
            if si == 0:
                inside = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
            else:
                inside = (np.abs(yy - cy) < r) & (np.abs(xx - cx) < r)
            img = np.where(inside[..., None], col, base)
            cap = f"a {self._COLORS[ci]} {self._SHAPES[si]}"
            yield (img * 255).astype(np.uint8), cap


@dataclasses.dataclass
class FolderSource:
    """Images under ``root`` (+ optional sidecar ``<stem>.txt`` captions),
    center-cropped/resized to ``hw``."""

    root: str
    hw: int = 512
    seed: int = 0
    exts: Sequence[str] = (".png", ".jpg", ".jpeg", ".webp")

    def __iter__(self):
        from PIL import Image

        files = sorted(
            f for f in os.listdir(self.root)
            if os.path.splitext(f)[1].lower() in self.exts
        )
        if not files:
            raise ValueError(f"no images under {self.root}")
        rng = np.random.RandomState(self.seed)
        while True:
            f = files[rng.randint(len(files))]
            im = Image.open(os.path.join(self.root, f)).convert("RGB")
            s = self.hw
            scale = s / min(im.size)
            im = im.resize((round(im.width * scale), round(im.height * scale)))
            x = (im.width - s) // 2
            y = (im.height - s) // 2
            img = np.asarray(im.crop((x, y, x + s, y + s)), np.uint8)
            cap_path = os.path.join(
                self.root, os.path.splitext(f)[0] + ".txt")
            cap = ""
            if os.path.exists(cap_path):
                with open(cap_path) as fh:
                    cap = fh.read().strip()
            yield img, cap


def prefetch(iterator, size: int = 2):
    """Background-thread prefetch: keeps ``size`` ready batches ahead of
    the consumer so host-side work (image decode, mask rasterization,
    tokenization) overlaps the card's work, as the reference stack's torch
    DataLoader workers do."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=size)
    _END = object()

    def worker():
        try:
            for item in iterator:
                q.put(item)
        except BaseException as e:  # surface producer errors to the consumer
            q.put(e)
            return
        q.put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def batches(
    source,
    tokenizer,
    batch_size: int,
    *,
    version: str = "ppt-v1",
    seed: int = 0,
    drop_prob: float = 0.1,
    tasks: Optional[Sequence[str]] = None,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield training batches: ``image_u8`` (B,H,W,3), ``mask_u8``
    (B,H,W,1, 255 = repaint), ``ids`` (B,77) [+ ``ids_plain`` for v2]."""
    tasks = tuple(tasks) if tasks else TASKS
    rng = np.random.RandomState(seed + 7)
    it = iter(source)
    # the empty-prompt row: CFG-style teachers (train/distill.py) need the
    # unconditional ids alongside every batch
    uncond = np.asarray(tokenizer([""])[0])
    while True:
        imgs: List[np.ndarray] = []
        msks: List[np.ndarray] = []
        ids: List[np.ndarray] = []
        ids_plain: List[np.ndarray] = []
        for _ in range(batch_size):
            img, cap = next(it)
            h, w = img.shape[:2]
            task = tasks[rng.randint(len(tasks))]
            m = random_mask(rng, h, w, kind=_TASK_MASK_KIND[task])
            dropped = rng.rand() < drop_prob
            if version == "ppt-v2":
                row = build_v2_prompt_ids(tokenizer, cap, task,
                                          dropped=dropped)
                ids.append(row["ids"])
                ids_plain.append(row["ids_plain"])
            else:
                ids.append(build_prompt_ids(tokenizer, cap, task,
                                            dropped=dropped))
            imgs.append(img)
            msks.append((m >= 0.5).astype(np.uint8)[..., None] * 255)
        batch = {
            "image_u8": np.stack(imgs),
            "mask_u8": np.stack(msks),
            "ids": np.stack(ids),
            "ids_uncond": np.tile(uncond[None], (batch_size, 1)),
        }
        if version == "ppt-v2":
            batch["ids_plain"] = np.stack(ids_plain)
        yield batch
