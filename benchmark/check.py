"""What decides ``correct``: a sample of the window's requests, served again by
the plain float32 reference, against the images the window returned.

The sample is drawn from the run's seed among the requests completed in
the window (each served there as a member of a batch), ``sample`` of them
(``limits/<workload>.json``). The reference runs after the served system
is freed, with TF32 off, one request at a time, on the weights the
benchmark made (float32 copies), and works out everything else from the
request.

The numbers, each the largest over the sample:

- ``image_mae``: the mean absolute difference of the two uint8 images, in
  levels of 255;
- ``image_rmse``: their root-mean-square difference, in levels;
- ``image_absmax``: their largest difference, in levels.

``limits/<workload>.json`` gives ``sample``, the limit of each number that
is compared, and the readings each limit was set from: the served
system's bf16 images (the lower reading) and the control's (the upper
reading), the reference in fp8 in the served system's place
(``reference.lowp``). Every number is printed on standard error.
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Dict

import numpy as np
import torch

from benchmark.reference import lowp
from benchmark.reference.models import load
from benchmark.reference.pipelines import generate
from benchmark.traffic import reference_request
from benchmark.weights import families_on_meta


def gaps(port: np.ndarray, ref: np.ndarray) -> Dict[str, float]:
    d = port.astype(np.float64) - ref.astype(np.float64)
    return {"image_mae": float(np.abs(d).mean()), "image_rmse": float(np.sqrt((d * d).mean())),
            "image_absmax": float(np.abs(d).max())}


def sample_keys(run, n: int) -> list:
    keys = sorted((r.client, r.index) for r in run.main.completed())
    rng = np.random.default_rng([run.seed & (2 ** 64 - 1), 0xC4EC])
    picks = rng.choice(len(keys), size=min(n, len(keys)), replace=False)
    return [keys[k] for k in sorted(picks)]


def reference_models(config: dict, state: dict, device) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return {fam: load(m, state[fam], device) for fam, m in families_on_meta(config).items()}


def reference_images(config: dict, state: dict, device, requests: list,
                     control: bool = False) -> list:
    """The reference's uint8 image of each request (``traffic`` requests);
    ``control``: computed in fp8 (``reference.lowp``), the control."""
    models = reference_models(config, state, device)
    with lowp.fp8_operands() if control else contextlib.nullcontext():
        out = [generate(models, config, reference_request(r), device) for r in requests]
    del models
    return out


def worst(pairs, limits: dict) -> Dict[str, dict]:
    """{number: {"value": the largest over the (served, reference) image
    pairs, "limit": its limit}}; with no pair, every number reads
    infinity."""
    values = {n: (float("inf") if not pairs else 0.0) for n in limits["numbers"]}
    for port, ref in pairs:
        g = gaps(port, ref)
        print(", ".join(f"{k} {v:.4f}" for k, v in g.items()), file=sys.stderr)
        for n in values:
            values[n] = max(values[n], g[n])
    return {n: {"value": values[n], "limit": limits["numbers"][n]} for n in values}


def compare(run, traffic, state: dict, device, limits: dict) -> Dict[str, dict]:
    """The numbers of a run's sample of its window against the reference."""
    keys = sample_keys(run, int(limits["sample"]))
    t0 = time.perf_counter()
    refs = reference_images(run.config, state, device, [traffic.request(c, i) for c, i in keys])
    print(f"reference: {len(keys)} requests in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return worst([(run.outputs[k], ref) for k, ref in zip(keys, refs)], limits)

