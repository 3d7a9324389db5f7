"""Control-image preprocessors for the ControlNet path (the port of
``powerpaint_tpu/tasks/control.py``): canny, DPT depth, HED edges and, in
``tasks/pose.py``, OpenPose body.

canny runs on the host with the reference thresholds (100 / 200). Depth,
HED and pose run their networks (``models/dpt.py``,
``models/annotators.py``) on a device in fp32 at PyTorch's default
precision (cuDNN convolutions in TF32, matmuls in fp32: how the reference's
torch annotators run on CUDA), from a state dict with the published
checkpoint's names or a local checkpoint. Their weights are not
bundled, so ``get_control_image`` raises for them until a preprocessor is
registered (``register_dpt_depth``, ``register_hed``,
``register_openpose``, or ``register_preprocessor`` for any callable).

The JAX package makes these maps with OpenCV, which the GPU host does not
have; the port calls ``tasks.imgproc`` (OpenCV's Canny, resizes, Gaussian
blur and dilation written out, bitwise on uint8) and ``tasks.drawing``
instead, and imports no OpenCV. HED's resizes and its scribble pass run on
its device, so its network input never leaves the card.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from powerpaint_tpu_torch.tasks import imgproc

_REGISTRY: Dict[str, Callable[[np.ndarray], np.ndarray]] = {}
_ANNOTATORS = {"depth": "register_dpt_depth", "hed": "register_hed",
               "pose": "register_openpose"}


def register_preprocessor(name: str, fn: Callable[[np.ndarray], np.ndarray]):
    _REGISTRY[name] = fn


def canny(image: np.ndarray, low: int = 100, high: int = 200) -> np.ndarray:
    """Canny edges (``cv2.Canny``'s, bit for bit) of an (H, W, 3) uint8
    image, as (H, W, 3) uint8."""
    edges = imgproc.canny(image, low, high)
    return np.stack([edges] * 3, axis=-1)


register_preprocessor("canny", canny)


def _cubic_weights(n_in: int, n_out: int, a: float = -0.75):
    """Separable cubic-convolution taps, torch ``interpolate(mode='bicubic',
    align_corners=False)`` semantics: half-pixel centres, Keys kernel with
    A = -0.75, border replication. (indices (n_out, 4) int64, weights
    (n_out, 4) float32)."""
    pos = (np.arange(n_out, dtype=np.float64) + 0.5) * n_in / n_out - 0.5
    i0 = np.floor(pos).astype(np.int64)
    idx = np.stack([i0 - 1, i0, i0 + 1, i0 + 2], axis=1)
    t = np.abs(pos[:, None] - idx)
    w = np.where(
        t <= 1.0,
        (a + 2.0) * t ** 3 - (a + 3.0) * t ** 2 + 1.0,
        np.where(t < 2.0,
                 a * t ** 3 - 5.0 * a * t ** 2 + 8.0 * a * t - 4.0 * a,
                 0.0))
    return np.clip(idx, 0, n_in - 1), w.astype(np.float32)


def resize_bicubic(x: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """(B, H, W) bicubic resize (torch align_corners=False semantics) as
    two gathers and weighted sums on x's device."""
    b, h, w = x.shape
    yi, yw = _cubic_weights(h, oh)
    xi, xw = _cubic_weights(w, ow)
    dev = x.device
    rows = x[:, torch.as_tensor(yi.ravel(), device=dev)]
    rows = (rows.view(b, oh, 4, w)
            * torch.as_tensor(yw, device=dev)[None, :, :, None]).sum(dim=2)
    cols = rows[:, :, torch.as_tensor(xi.ravel(), device=dev)]
    return (cols.view(b, oh, ow, 4)
            * torch.as_tensor(xw, device=dev)[None, None]).sum(dim=3)


class DPTDepthPreprocessor:
    """DPT monocular depth control map: DPT forward, bicubic resize to
    ``output_size``, per-image min/max normalisation, 3-channel uint8.

    ``checkpoint``: a local DPT-hybrid checkpoint directory (``config.json``
    and ``*.safetensors`` or ``*.bin``); or ``state`` (a state dict with HF
    ``DPTForDepthEstimation`` names) and ``config``. The network runs on
    ``device`` in fp32."""

    def __init__(self, checkpoint: Optional[str] = None, state=None,
                 config=None, output_size=(1024, 1024), device="cuda"):
        from powerpaint_tpu_torch.core.config import dpt_config_from_hf_dict
        from powerpaint_tpu_torch.io.weights import load_annotator

        if state is None:
            if checkpoint is None:
                raise ValueError("need state or checkpoint")
            with open(os.path.join(checkpoint, "config.json")) as f:
                config = dpt_config_from_hf_dict(json.load(f))
            files = (sorted(glob.glob(os.path.join(checkpoint, "*.safetensors")))
                     or sorted(glob.glob(os.path.join(checkpoint, "*.bin"))))
            if not files:
                raise FileNotFoundError(f"no weights under {checkpoint}")
            checkpoint = files[0]
        if config is None:
            raise ValueError("need config with state")
        self.config = config
        self.output_size = tuple(output_size)
        self.device = torch.device(device)
        self.model = load_annotator("dpt", state, checkpoint=checkpoint,
                                    config=config, device=self.device)

    def preprocess(self, image: np.ndarray) -> np.ndarray:
        """uint8 RGB -> (1, S, S, 3) float32: the DPTImageProcessor transform
        (PIL bicubic resize to the model's square input, 1/255, mean and std
        0.5)."""
        from PIL import Image

        s = self.config.image_size
        pil = Image.fromarray(image).resize((s, s), Image.BICUBIC)
        x = np.asarray(pil, np.float32) / 255.0
        return ((x - 0.5) / 0.5)[None]

    @torch.no_grad()
    def depth(self, x) -> torch.Tensor:
        """(B, oh, ow) depth normalised to [0, 1] per image, on the device."""
        d = self.model(torch.as_tensor(x, device=self.device))
        up = resize_bicubic(d, *self.output_size)
        dmin = up.amin(dim=(1, 2), keepdim=True)
        dmax = up.amax(dim=(1, 2), keepdim=True)
        return (up - dmin) / torch.clamp(dmax - dmin, min=1e-8)

    def __call__(self, image: np.ndarray) -> np.ndarray:
        out = self.depth(self.preprocess(image))[0].cpu().numpy()
        out = (out * 255.0).clip(0, 255).astype(np.uint8)
        return np.stack([out] * 3, axis=-1)


def register_dpt_depth(**kwargs) -> DPTDepthPreprocessor:
    """Build the DPT depth preprocessor and register it as 'depth'."""
    pre = DPTDepthPreprocessor(**kwargs)
    register_preprocessor("depth", pre)
    return pre


def _fit_resolution(h: int, w: int, resolution: int) -> tuple:
    """Short side to ``resolution``, both sides rounded to multiples of 64
    (the annotators' operating scale)."""
    k = float(resolution) / min(h, w)
    return (max(64, int(round(h * k / 64.0)) * 64),
            max(64, int(round(w * k / 64.0)) * 64))


def safe_step(x: torch.Tensor, step: int = 2) -> torch.Tensor:
    """Quantise a [0, 1] map to ``step`` levels (the 'safe' mode)."""
    y = x.float() * float(step + 1)
    return y.to(torch.int32).float() / float(step)


_LINE_KERNELS = (
    np.array([[0, 0, 0], [1, 1, 1], [0, 0, 0]], np.uint8),
    np.array([[0, 1, 0], [0, 1, 0], [0, 1, 0]], np.uint8),
    np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1]], np.uint8),
    np.array([[0, 0, 1], [0, 1, 0], [1, 0, 0]], np.uint8),
)


def nms_edges(x, threshold: int, sigma: float):
    """Directional non-maximum suppression of a uint8 edge map, numpy or a
    tensor on its device (the 'scribble' pass): keep pixels that are maxima
    of their 3-neighbourhood along any of four line directions, then
    binarise."""
    t = torch.from_numpy(imgproc.writable(x)) if isinstance(x, np.ndarray) else x
    blurred = imgproc.gaussian_blur(t.float(), sigma)
    kept = torch.zeros_like(blurred)
    for kernel in _LINE_KERNELS:
        line_max = imgproc.dilate(blurred, kernel)
        kept = torch.where(line_max == blurred, blurred, kept)
    out = torch.where(kept > threshold, 255, 0).to(torch.uint8)
    return out.numpy() if isinstance(x, np.ndarray) else out


class HEDPreprocessor:
    """HED edge control map: resize the uint8 RGB image to the
    ``detect_resolution`` bucket (INTER_AREA down, INTER_LANCZOS4 up), one
    HEDNetwork forward on ``device`` (fp32), the edge probability as uint8,
    resized back (INTER_LINEAR). ``safe`` quantises the intensities;
    ``scribble`` applies directional NMS, a Gaussian blur and binarisation.
    The resizes and the scribble pass are ``tasks.imgproc``'s, on
    ``device``: the image goes up once and the map comes back once. An
    image already at its bucket's size (512 x 512 at the default
    resolution) is not resized (OpenCV's same-size resize is a copy).
    ``state`` is ``network-bsds500.pth``'s state dict (``module*`` or
    ``net*`` names), or ``checkpoint`` its path."""

    def __init__(self, state=None, checkpoint: Optional[str] = None,
                 detect_resolution: int = 512, safe: bool = False,
                 scribble: bool = False, device="cuda"):
        from powerpaint_tpu_torch.io.weights import load_annotator

        self.device = torch.device(device)
        self.model = load_annotator("hed", state, checkpoint=checkpoint,
                                    device=self.device)
        self.detect_resolution = detect_resolution
        self.safe = safe
        self.scribble = scribble

    @torch.no_grad()
    def probability(self, image: torch.Tensor) -> torch.Tensor:
        """(H, W) fp32 edge probability of an (H, W, 3) uint8 tensor on the
        device, at its own size. No RGB -> BGR flip, as the reference
        deployment (see ``models.annotators.HEDNetwork``)."""
        return self.model(image.float()[None] / 255.0)[0, :, :, 0]

    def edges(self, image: np.ndarray) -> np.ndarray:
        """``probability`` of a uint8 RGB numpy image, as numpy."""
        x = torch.as_tensor(imgproc.writable(image), device=self.device)
        return self.probability(x).cpu().numpy()

    def network_input(self, image) -> torch.Tensor:
        """The (h, w, 3) uint8 image at its bucket's size (a numpy image
        goes to the device first): INTER_AREA down, INTER_LANCZOS4 up."""
        x = torch.as_tensor(imgproc.writable(image), device=self.device) \
            if isinstance(image, np.ndarray) else image
        h0, w0 = x.shape[:2]
        h, w = _fit_resolution(h0, w0, self.detect_resolution)
        if (h, w) == (h0, w0):
            return x
        interp = imgproc.INTER_AREA if h <= h0 else imgproc.INTER_LANCZOS4
        return imgproc.resize(x, (w, h), interpolation=interp)

    def finish(self, edge: torch.Tensor, image_hw) -> torch.Tensor:
        """The (H, W) uint8 map from the bucket-size probability, on its
        device: safe steps, uint8, INTER_LINEAR back to ``image_hw``, the
        scribble pass."""
        if self.safe:
            edge = safe_step(edge)
        edge_u8 = (edge * 255.0).clamp(0, 255).to(torch.uint8)
        if tuple(edge_u8.shape) != tuple(image_hw):
            edge_u8 = imgproc.resize(edge_u8, tuple(image_hw)[::-1],
                                     interpolation=imgproc.INTER_LINEAR)
        if self.scribble:
            edge_u8 = nms_edges(edge_u8, 127, 3.0)
            edge_u8 = imgproc.gaussian_blur(edge_u8, 3.0)
            edge_u8 = torch.where(edge_u8 > 4, 255, 0).to(torch.uint8)
        return edge_u8

    def control_map(self, image: np.ndarray) -> torch.Tensor:
        """The (H, W) uint8 map on the device."""
        return self.finish(self.probability(self.network_input(image)),
                           image.shape[:2])

    def __call__(self, image: np.ndarray) -> np.ndarray:
        edge_u8 = self.control_map(image).cpu().numpy()
        return np.stack([edge_u8] * 3, axis=-1)


def register_hed(**kwargs) -> HEDPreprocessor:
    """Build the HED preprocessor and register it as 'hed'."""
    pre = HEDPreprocessor(**kwargs)
    register_preprocessor("hed", pre)
    return pre


def register_openpose(**kwargs):
    """Build the OpenPose body preprocessor and register it as 'pose'."""
    from powerpaint_tpu_torch.tasks.pose import OpenposeBodyPreprocessor

    pre = OpenposeBodyPreprocessor(**kwargs)
    register_preprocessor("pose", pre)
    return pre


def get_control_image(control_type: str, image: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 control map of ``image`` for ``control_type``; depth,
    hed and pose raise until a preprocessor is registered (their weights
    are not bundled)."""
    if control_type in _REGISTRY:
        return _REGISTRY[control_type](image)
    if control_type in _ANNOTATORS:
        raise NotImplementedError(
            f"control type {control_type!r} needs its annotator network and "
            "weights; register one with powerpaint_tpu_torch.tasks.control."
            f"{_ANNOTATORS[control_type]}(state=... or checkpoint=...) or "
            "register_preprocessor, or pass control_image")
    raise NotImplementedError(
        f"unknown control type {control_type!r}; register one with "
        "powerpaint_tpu_torch.tasks.control.register_preprocessor"
        f" (available: {sorted(_REGISTRY)})")
