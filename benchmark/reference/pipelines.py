"""The plain reference of one served request: PowerPaint's task prompts and
their tokenization, the fitting-degree blend, the VAE sample of the masked
image, classifier-free guidance over the DDIM (ppt-v1) or UniPC (ppt-v2)
loop, and the decode to uint8, all in float32 on ``torch`` operations.

It takes the request's inputs (image, mask, prompt, negative prompt, task,
fitting degree, guidance, seed, steps) and the benchmark's weights, and
works everything else out again: the token ids, the text embeddings, the
noise (each image's ``torch.Generator`` seeded with the request's seed and
drawn in the served system's documented order: the initial latent noise,
then the VAE sample noise of the masked image, then, on ppt-v1, the image
latents' noise), the samplers' tables and the latents.

The tokenizer is a frozen copy of the served system's stand-in for CLIP's
vocabulary (the repository has no vocabulary file): each whitespace word's
SHA-1 hashed into [1000, vocab - 2), the ten rows of each task token
appended after the vocabulary, bos / eos / eos padding to 77.

UniPC is written as diffusers' ``UniPCMultistepScheduler`` steps it (bh2,
data prediction, order 2, ``lower_order_final``, a list of past data
predictions, the order conditions solved at each step), on the served
system's timestep grid: "leading" spacing with ``T // S`` between steps and
``steps_offset`` added, the last step going to t = 0.
"""

from __future__ import annotations

import hashlib
import re
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.models import TASK_TOKENS

MAX_LEN = 77
ROWS_PER_TASK_TOKEN = 10
_V1_NEG_SUFFIX = ", worst quality, low quality, normal quality, bad quality, blurry "


def _words(text: str) -> List[str]:
    return [w for w in re.sub(r"\s+", " ", text).strip().split(" ") if w]


def tokenize(texts: List[str], vocab: int) -> np.ndarray:
    """(len(texts), 77) int64 ids."""
    added = {}
    for name in TASK_TOKENS:
        for k in range(ROWS_PER_TASK_TOKEN):
            added[f"{name}_{k}"] = vocab + len(added)
    rows = []
    for text in texts:
        for name in TASK_TOKENS:
            text = text.replace(name, " ".join(
                f"{name}_{k}" for k in range(ROWS_PER_TASK_TOKEN)))
        ids = []
        for chunk in _words(text):
            if chunk in added:
                ids.append(added[chunk])
                continue
            for w in _words(chunk.lower()):
                h = int.from_bytes(hashlib.sha1(w.encode("utf-8")).digest()[:4],
                                   "little")
                ids.append(1000 + h % (vocab - 1002))
        row = [vocab - 2] + ids[:MAX_LEN - 2] + [vocab - 1]
        rows.append(row + [vocab - 1] * (MAX_LEN - len(row)))
    return np.asarray(rows, np.int64)


def task_prompts(prompt: str, negative: str, task: str, version: str) -> Dict[str, str]:
    """PowerPaint's prompts A, B and their negatives for ``task``, and for
    ppt-v2 the plain pair U of the base UNet."""
    v1 = version == "ppt-v1"
    if not v1:
        prompt = prompt + {"image-outpainting": " empty scene",
                           "object-removal": " empty scene blur"}.get(task, "")
    if task in ("object-removal", "image-outpainting"):
        pos = f"empty scene blur {prompt}" if v1 else ""
        neg = negative if v1 else ""
        a, b, na, nb = pos + " P_ctxt", pos + " P_ctxt", neg + " P_obj", neg + " P_obj"
    elif task == "shape-guided":
        pos = prompt if v1 else ""
        neg = negative + _V1_NEG_SUFFIX if v1 else ""
        a, b, na, nb = pos + " P_shape", pos + " P_ctxt", neg + "P_shape", neg + "P_ctxt"
    else:
        pos = prompt if v1 else ""
        neg = negative + _V1_NEG_SUFFIX if v1 else ""
        a, b, na, nb = pos + " P_obj", pos + " P_obj", neg + "P_obj", neg + "P_obj"
    return {"A": a, "B": b, "negA": na, "negB": nb, "U": prompt, "negU": negative}


def timesteps(sch: dict, steps: int) -> np.ndarray:
    T = sch["num_train_timesteps"]
    if sch["timestep_spacing"] != "leading":
        raise ValueError("the reference follows leading spacing")
    ts = (np.arange(steps) * (T // steps)).round()[::-1].astype(np.int64)
    return np.clip(ts + sch["steps_offset"], 0, T - 1)


def alphas_cumprod(sch: dict) -> np.ndarray:
    if sch["beta_schedule"] != "scaled_linear":
        raise ValueError("the reference follows scaled_linear betas")
    betas = np.linspace(sch["beta_start"] ** 0.5, sch["beta_end"] ** 0.5,
                        sch["num_train_timesteps"], dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


class DDIM:
    """eta = 0 DDIM, epsilon prediction, ``set_alpha_to_one`` False."""

    def __init__(self, sch: dict, steps: int):
        self.acp = alphas_cumprod(sch)
        self.ts = timesteps(sch, steps)
        self.ratio = sch["num_train_timesteps"] // steps
        self.final = 1.0 if sch["set_alpha_to_one"] else self.acp[0]

    def step(self, i: int, eps: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        t = int(self.ts[i])
        prev = t - self.ratio
        a, a_prev = self.acp[t], (self.acp[prev] if prev >= 0 else self.final)
        x0 = (x - np.sqrt(1.0 - a) * eps) / np.sqrt(a)
        return np.sqrt(a_prev) * x0 + np.sqrt(1.0 - a_prev) * eps


class UniPC:
    """diffusers' UniPC multistep (bh2, predict x0, solver order 2,
    lower_order_final), one ``step`` per model evaluation."""

    def __init__(self, sch: dict, steps: int):
        if sch["solver_type"] != "bh2" or sch["solver_order"] != 2:
            raise ValueError("the reference follows bh2 at order 2")
        acp = alphas_cumprod(sch)
        self.alpha, self.sigma = np.sqrt(acp), np.sqrt(1.0 - acp)
        self.lam = np.log(self.alpha) - np.log(self.sigma)
        self.ts = timesteps(sch, steps)
        self.lower_order_final = sch["lower_order_final"]
        self.outputs: List[torch.Tensor] = []
        self.t_list: List[int] = []
        self.last_sample = None
        self.order = 1
        self.lower_order_nums = 0

    def _coeffs(self, t: int, s0: int):
        h = self.lam[t] - self.lam[s0]
        hh = -h
        h_phi_1 = np.expm1(hh)
        B_h = np.expm1(hh)
        return h, hh, h_phi_1, B_h

    def _rb(self, rks, hh, B_h, order):
        h_phi_k = np.expm1(hh) / hh - 1.0
        R, b, fact = [], [], 1
        for i in range(1, order + 1):
            R.append(np.power(rks, i - 1))
            b.append(h_phi_k * fact / B_h)
            fact *= i + 1
            h_phi_k = h_phi_k / hh - 1.0 / fact
        return np.stack(R), np.array(b)

    def _update(self, x, t: int, order: int, corrector_out=None):
        """From the sample ``x`` at the latest recorded timestep to ``t``,
        with the recorded data predictions; ``corrector_out`` (the data
        prediction at ``t``) makes it the corrector."""
        m0, s0 = self.outputs[-1], self.t_list[-1]
        h, hh, h_phi_1, B_h = self._coeffs(t, s0)
        a_t, s_t, sg_s0 = self.alpha[t], self.sigma[t], self.sigma[s0]
        rks, D1s = [], []
        for i in range(1, order):
            si, mi = self.t_list[-(i + 1)], self.outputs[-(i + 1)]
            rk = (self.lam[si] - self.lam[s0]) / h
            rks.append(rk)
            D1s.append((mi - m0) / rk)
        rks.append(1.0)
        R, b = self._rb(np.array(rks), hh, B_h, order)
        x_t = s_t / sg_s0 * x - a_t * h_phi_1 * m0
        if corrector_out is None:
            if D1s:
                rhos = [0.5] if order == 2 else np.linalg.solve(R[:-1, :-1], b[:-1])
                x_t = x_t - a_t * B_h * sum(r * d for r, d in zip(rhos, D1s))
            return x_t
        rhos = [0.5] if order == 1 else np.linalg.solve(R, b)
        corr = sum(r * d for r, d in zip(rhos[:-1], D1s)) if D1s else 0.0
        return x_t - a_t * B_h * (corr + rhos[-1] * (corrector_out - m0))

    def step(self, i: int, eps: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        t = int(self.ts[i])
        m = (x - self.sigma[t] * eps) / self.alpha[t]
        if i > 0:
            x = self._update(self.last_sample, t, self.order, corrector_out=m)
        self.outputs = (self.outputs + [m])[-2:]
        self.t_list = (self.t_list + [t])[-2:]
        order = min(2, len(self.ts) - i) if self.lower_order_final else 2
        self.order = min(order, self.lower_order_nums + 1)
        self.last_sample = x
        t_next = int(self.ts[i + 1]) if i + 1 < len(self.ts) else 0
        x_next = self._update(x, t_next, self.order)
        self.lower_order_nums = min(self.lower_order_nums + 1, 2)
        return x_next


def _noise(seed: int, shape, count: int, device) -> List[torch.Tensor]:
    """The served system's draws for one image: ``count`` (h, w, 4)
    standard normals from a generator seeded with ``seed``, as NCHW."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    return [torch.randn(shape, generator=g, device=device).permute(2, 0, 1)[None]
            for _ in range(count)]


def _blend(emb: torch.Tensor, fitting: float):
    """(4, 77, D) [A, B, negA, negB] -> the CFG pair (2, 77, D) [neg, pos]."""
    t = torch.tensor(float(np.float32(fitting)), device=emb.device)
    pos = emb[0] * t + (1.0 - t) * emb[1]
    neg = emb[2] * t + (1.0 - t) * emb[3]
    return torch.stack([neg, pos])


def _vae_sample(vae, image: torch.Tensor, noise: torch.Tensor, sf: float):
    mean, logvar = vae.encode(image)
    return (mean + torch.exp(0.5 * logvar) * noise) * sf


def _to_u8(image: torch.Tensor) -> np.ndarray:
    img = torch.clamp(image / 2 + 0.5, 0.0, 1.0)
    return torch.round(img * 255.0).to(torch.uint8)[0].permute(1, 2, 0).cpu().numpy()


@torch.no_grad()
def generate(models: dict, config: dict, request: dict, device) -> np.ndarray:
    """One request -> (H, W, 3) uint8. ``request``: image (H, W, 3) uint8,
    mask (H, W) float, prompt, negative_prompt, task, fitting_degree,
    guidance_scale, seed, num_inference_steps; ``models`` from
    ``models.families`` with the weights loaded."""
    v1 = config.get("brushnet") is None
    version = "ppt-v1" if v1 else "ppt-v2"
    vocab = config["text_encoder"]["vocab_size"]
    sf = config["vae"]["scaling_factor"]
    sch = config["scheduler"]
    steps = int(request["num_inference_steps"])
    image = torch.as_tensor(request["image"], device=device).permute(2, 0, 1)[None].float()
    hole = (torch.as_tensor(np.asarray(request["mask"], np.float32), device=device)
            >= 0.5).float()[None, None]
    _, _, h, w = image.shape
    noise = _noise(request["seed"], (h // 8, w // 8, 4), 3 if v1 else 2, device)
    p = task_prompts(request["prompt"], request["negative_prompt"], request["task"], version)
    ids = torch.as_tensor(tokenize([p["A"], p["B"], p["negA"], p["negB"]], vocab),
                          device=device)
    g = float(np.float32(request["guidance_scale"]))
    vae = models["vae"]
    if v1:
        cond = _blend(models["text_encoder"](ids), request["fitting_degree"])
        init = image / 127.5 - 1.0
        masked_lat = _vae_sample(vae, init * (1.0 - hole), noise[1], sf)
        extra = torch.cat([F.interpolate(hole, size=(h // 8, w // 8), mode="nearest-exact"),
                           masked_lat], dim=1).repeat(2, 1, 1, 1)
        sampler = DDIM(sch, steps)

        def eps_of(x, t):
            return models["unet"](torch.cat([x.repeat(2, 1, 1, 1), extra], dim=1), t, cond)
    else:
        cond_task = _blend(models["text_encoder_brushnet"](ids), request["fitting_degree"])
        ids_u = np.minimum(tokenize([p["U"], p["negU"]], vocab), vocab - 1)
        plain = models["text_encoder"](torch.as_tensor(ids_u, device=device))
        cond_plain = torch.stack([plain[1], plain[0]])
        keep = 1.0 - hole
        cond_lat = _vae_sample(vae, image * keep / 127.5 - 1.0, noise[1], sf)
        cond5 = torch.cat([cond_lat, F.interpolate(keep, size=(h // 8, w // 8),
                                                   mode="nearest-exact")],
                          dim=1).repeat(2, 1, 1, 1)
        sampler = UniPC(sch, steps)

        def eps_of(x, t):
            x2 = x.repeat(2, 1, 1, 1)
            taps = models["brushnet"](x2, t, cond_task, cond5)
            return models["unet"](x2, t, cond_plain, taps)
    latents = noise[0]
    for i, t in enumerate(sampler.ts):
        eps = eps_of(latents, torch.tensor(int(t), device=device))
        eps = eps[:1] + g * (eps[1:] - eps[:1])
        latents = sampler.step(i, eps, latents)
    return _to_u8(vae.decode(latents / sf))
