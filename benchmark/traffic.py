"""The one traffic generator: every request of a mix, and when it is sent,
made from the run's seed by the parameters of a traffic file
(``traffic/<name>.json``).

Request ``index`` of client ``client`` is drawn from its own numpy
generator, seeded with (seed, client, index), so a request is the same
whatever the order in which clients reach it, and every seed gives the same
sizes, steps and tasks: only contents, masks, prompts, fitting degrees,
noise seeds and (for more than one task) the order of the tasks change.

Parameters of a traffic file:

- ``loop``: "closed" (each of ``clients`` sends its next request when the
  last one returns) or "open" (requests are sent at the times of
  ``arrivals``, whether or not the earlier ones have returned);
- ``arrivals`` (open loop): {"process": "poisson" or "uniform", "rate":
  requests a second, "burst": requests sent together at each arrival
  (default 1)}; the gaps are drawn from a generator of their own that the
  seed does not key, in blocks that the seed only shuffles, so every seed
  sends the same gaps in another order;
- ``server``: the served system's settings, each defaulting to the
  server's (``SERVER_DEFAULTS``): ``max_batch``, ``window_ms``,
  ``pipeline_depth`` of the micro-batcher, and ``int8``;
- ``image``: [height, width] of the user's image; ``outpaint``: null or
  [horizontal, vertical] expansion of the canvas, the served system's
  outpainting canvas (the image centred on grey 127, the hole the border
  and a 10-pixel band inside the image on each expanded side);
- ``mask``: {"kinds": ["rect", "stroke"], "cover": [lo, hi]}: rectangles
  and brush strokes (the pool alternates the kinds), each covering a
  fraction drawn from [lo, hi] of the image (ignored when outpainting);
- ``task``, ``num_inference_steps``, ``guidance_scale``,
  ``negative_prompt``, ``scheduler`` (null: the configuration's default);
- ``prompts``: drawn uniformly per request; ``fitting_degree``: [lo, hi],
  drawn uniformly;
- ``tasks`` (optional): a list of entries, each drawn per request with
  probability in proportion to its ``weight``; an entry holds ``task`` and
  any of the parameters above from ``image`` to ``fitting_degree``, which
  override the mix's own for its requests (its own images and masks too);
- ``pool``: how many images and masks set-up draws for each entry's
  requests to pick from.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

SEED_MAX = 2 ** 31 - 1
GAP = 10
POOL = 1 << 30  # the key of the pools' draws, outside every client's


def _rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), *keys])


def _image(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """A smooth random colour field with fine noise on it."""
    coarse = rng.uniform(0, 255, size=(h // 64 + 2, w // 64 + 2, 3))
    ys = np.linspace(0, coarse.shape[0] - 1.001, h)
    xs = np.linspace(0, coarse.shape[1] - 1.001, w)
    y0, x0 = ys.astype(int), xs.astype(int)
    fy, fx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    top = coarse[y0][:, x0] * (1 - fx) + coarse[y0][:, x0 + 1] * fx
    bot = coarse[y0 + 1][:, x0] * (1 - fx) + coarse[y0 + 1][:, x0 + 1] * fx
    field = top * (1 - fy) + bot * fy + rng.normal(0, 12, size=(h, w, 3))
    return np.clip(field, 0, 255).astype(np.uint8)


def _rect(rng, h: int, w: int, cover: float) -> np.ndarray:
    aspect = rng.uniform(0.5, 2.0)
    rh = min(h, int(round(np.sqrt(cover * h * w / aspect))))
    rw = min(w, int(round(cover * h * w / max(rh, 1))))
    y, x = rng.integers(0, h - rh + 1), rng.integers(0, w - rw + 1)
    m = np.zeros((h, w), np.float32)
    m[y:y + rh, x:x + rw] = 1.0
    return m


def _stroke(rng, h: int, w: int, cover: float) -> np.ndarray:
    """A thick brush stroke, a random walk of segments, drawn on a grid of a
    quarter of the size until it covers ``cover`` of it."""
    gh, gw = h // 4, w // 4
    yy, xx = np.mgrid[0:gh, 0:gw].astype(np.float32)
    radius = rng.uniform(0.05, 0.10) * min(gh, gw)
    m = np.zeros((gh, gw), bool)
    p = np.array([rng.uniform(0, gh), rng.uniform(0, gw)])
    for _ in range(64):
        angle = rng.uniform(0, 2 * np.pi)
        q = np.clip(p + rng.uniform(0.2, 0.5) * min(gh, gw) *
                    np.array([np.sin(angle), np.cos(angle)]), 0, [gh - 1, gw - 1])
        d = q - p
        t = np.clip(((yy - p[0]) * d[0] + (xx - p[1]) * d[1]) / max(d @ d, 1e-6), 0, 1)
        m |= (yy - p[0] - t * d[0]) ** 2 + (xx - p[1] - t * d[1]) ** 2 <= radius ** 2
        p = q
        if m.mean() >= cover:
            break
    return np.kron(m.astype(np.float32), np.ones((4, 4), np.float32))[:h, :w]


def outpaint_canvas(image: np.ndarray, hx: float, vx: float):
    """The image centred on a grey canvas expanded by (hx, vx), and the
    hole: the border and a band of ``GAP`` pixels inside each expanded side."""
    o_h, o_w = image.shape[:2]
    c_h, c_w = int(vx * o_h), int(hx * o_w)
    canvas = np.full((c_h, c_w, 3), 127, np.uint8)
    y0, x0 = int((c_h - o_h) / 2.0), int((c_w - o_w) / 2.0)
    canvas[y0:y0 + o_h, x0:x0 + o_w] = image
    mask = np.ones((c_h, c_w), np.float32)
    gy = GAP if vx != 1.0 else 0
    gx = GAP if hx != 1.0 else 0
    mask[y0 + gy:y0 + o_h - gy, x0 + gx:x0 + o_w - gx] = 0.0
    return canvas, mask


SERVER_DEFAULTS = {"max_batch": 4, "window_ms": 20.0, "pipeline_depth": 2, "int8": False}
# the parameters a ``tasks`` entry may override
ENTRY_KEYS = ("image", "outpaint", "mask", "task", "num_inference_steps", "guidance_scale",
              "negative_prompt", "scheduler", "prompts", "fitting_degree")
ARRIVALS = 1 << 29  # the key of the arrival gaps' draws, outside every client's
ARRIVAL_BLOCK = 256


class Traffic:
    """The requests of one mix under one seed.

    The images and masks are drawn in set-up, ``pool`` of each for each
    entry (the outpainting canvases with their fixed border hole), and each
    request picks its entry, one image and one mask of it, and draws its
    prompt, fitting degree and noise seed: a request costs its client
    microseconds, the same for every seed, so the clients' own work neither
    varies with the seed nor competes with the served system's host threads
    in the window."""

    def __init__(self, spec: dict, seed: int, default_scheduler: str):
        if spec.get("loop") not in ("closed", "open"):
            raise ValueError(f"unsupported loop {spec.get('loop')!r}")
        self.spec = spec
        self.seed = int(seed)
        self.loop = spec["loop"]
        self.clients = int(spec["clients"]) if self.loop == "closed" else 0
        self.server = {**SERVER_DEFAULTS, **spec.get("server", {})}
        base = {k: spec.get(k) for k in ENTRY_KEYS}
        self.entries = [{**base, **{k: v for k, v in e.items() if k in ENTRY_KEYS}}
                        for e in spec.get("tasks") or [{}]]
        weights = np.array([float(e.get("weight", 1.0)) for e in spec.get("tasks") or [{}]])
        self.cumulative = np.cumsum(weights / weights.sum())
        self.pools = [self._pool(e, k) for k, e in enumerate(self.entries)]
        for e in self.entries:
            e["scheduler"] = e["scheduler"] or default_scheduler

    def _pool(self, entry: dict, e: int):
        """``pool`` images and masks for an entry (the first entry's draws
        keyed as a mix of one task)."""
        h, w = entry["image"]
        images, masks = [], []
        for k in range(int(self.spec["pool"])):
            rng = _rng(self.seed, POOL, k) if e == 0 else _rng(self.seed, POOL, e, k)
            image = _image(rng, h, w)
            if entry.get("outpaint"):
                image, mask = outpaint_canvas(image, *entry["outpaint"])
            else:
                kinds = entry["mask"]["kinds"]
                kind = kinds[k % len(kinds)]
                mask = (_rect if kind == "rect" else _stroke)(
                    rng, h, w, rng.uniform(*entry["mask"]["cover"]))
            images.append(image)
            masks.append(mask)
        return images, masks

    def canvases(self):
        """The canvas of each entry's requests, in entry order."""
        return [images[0].shape[:2] for images, _ in self.pools]

    def request(self, client: int, index: int, entry: int = None) -> Dict:
        """Request ``index`` of ``client``: image, mask and the call's
        keyword arguments (``kwargs``), as the served system takes them.
        ``entry`` fixes the task entry (for warming up); by default a mix
        of more than one draws it."""
        rng = _rng(self.seed, client, index)
        if entry is None:
            entry = (0 if len(self.entries) == 1
                     else int(np.searchsorted(self.cumulative, rng.uniform(), side="right")))
            entry = min(entry, len(self.entries) - 1)
        e = self.entries[entry]
        images, masks = self.pools[entry]
        n = len(images)
        lo, hi = e["fitting_degree"]
        kwargs = dict(
            prompt=e["prompts"][int(rng.integers(len(e["prompts"])))],
            negative_prompt=e.get("negative_prompt") or "",
            task=e["task"],
            fitting_degree=float(rng.uniform(lo, hi)),
            guidance_scale=float(e["guidance_scale"]),
            seed=int(rng.integers(0, SEED_MAX)),
            num_inference_steps=int(e["num_inference_steps"]),
            scheduler=e["scheduler"],
        )
        return {"image": images[int(rng.integers(n))],
                "mask": masks[int(rng.integers(n))], "kwargs": kwargs}

    def warmup(self, entry: int, n: int, offset: int = 1 << 20, steps: int = 3) -> list:
        """``n`` requests of one entry outside every client's stream, for
        warming up: the entry's shapes at ``steps`` sampler steps (three
        reach every update of the samplers' second order)."""
        reqs = [self.request(offset, i, entry) for i in range(n)]
        for r in reqs:
            r["kwargs"]["num_inference_steps"] = steps
        return reqs

    def arrivals(self):
        """The open loop's send times, seconds from the loop's start, one
        per request, without end: gaps of the arrival process between
        bursts, a burst's requests sent together."""
        a = self.spec["arrivals"]
        burst = int(a.get("burst", 1))
        mean_gap = burst / float(a["rate"])
        t, block = 0.0, 0
        while True:
            fixed = _rng(ARRIVALS, block)
            if a["process"] == "poisson":
                gaps = fixed.exponential(mean_gap, ARRIVAL_BLOCK)
            elif a["process"] == "uniform":
                gaps = np.full(ARRIVAL_BLOCK, mean_gap)
            else:
                raise ValueError(f"unsupported arrival process {a['process']!r}")
            for gap in _rng(self.seed, ARRIVALS, block).permutation(gaps):
                for _ in range(burst):
                    yield t
                t += float(gap)
            block += 1


def reference_request(req: Dict) -> Dict:
    """The fields the plain reference takes."""
    out = dict(req["kwargs"])
    out.update(image=req["image"], mask=req["mask"])
    return out

