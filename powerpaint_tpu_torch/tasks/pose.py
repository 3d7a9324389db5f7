"""OpenPose body estimation: the network on the device, the decode and the
drawing on the host (the port of ``powerpaint_tpu/tasks/pose.py``; the CMU
bottom-up algorithm, Cao et al., CVPR 2017): heatmap peaks, part-affinity
line integrals, greedy limb matching, skeleton assembly, and the
18-keypoint skeleton the pose ControlNet was trained on.

The constants (boxsize 368, stride 8, thresholds 0.1 / 0.05, the 19-limb
sequence and its PAF channel map, the distance prior) are the published
CMU values. ``OpenposeBodyPreprocessor`` runs in three steps that can be
called apart: ``network_input`` (the bicubic resize and the 128 pad),
``forward`` (``models.annotators.BodyPoseModel`` on the device) and
``decode`` (the fields' bicubic upsample, then numpy and scipy). The JAX
package resizes and draws with OpenCV, which the GPU host does not have:
the resizes here are ``tasks.imgproc``'s (OpenCV's arithmetic, run on the
device), the drawing ``tasks.drawing``'s. scipy is imported where it is
used.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from powerpaint_tpu_torch.tasks import drawing, imgproc

# 18 keypoints: nose, neck, shoulders, elbows, wrists, hips, knees, ankles,
# eyes, ears. Limbs are 1-indexed keypoint pairs; MAP_IDX names each limb's
# PAF channel pair (offset by the 19 heatmap channels of the original
# layout).
LIMB_SEQ = (
    (2, 3), (2, 6), (3, 4), (4, 5), (6, 7), (7, 8), (2, 9), (9, 10),
    (10, 11), (2, 12), (12, 13), (13, 14), (2, 1), (1, 15), (15, 17),
    (1, 16), (16, 18), (3, 17), (6, 18),
)
MAP_IDX = (
    (31, 32), (39, 40), (33, 34), (35, 36), (41, 42), (43, 44), (19, 20),
    (21, 22), (23, 24), (25, 26), (27, 28), (29, 30), (47, 48), (49, 50),
    (53, 54), (51, 52), (55, 56), (37, 38), (45, 46),
)
COLORS = (
    (255, 0, 0), (255, 85, 0), (255, 170, 0), (255, 255, 0), (170, 255, 0),
    (85, 255, 0), (0, 255, 0), (0, 255, 85), (0, 255, 170), (0, 255, 255),
    (0, 170, 255), (0, 85, 255), (0, 0, 255), (85, 0, 255), (170, 0, 255),
    (255, 0, 255), (255, 0, 170), (255, 0, 85),
)

BOXSIZE = 368
STRIDE = 8
WIDTH_BUCKET = 64
PAD_VALUE = 128
THRE_PEAK = 0.1
THRE_PAF = 0.05
N_MIDPOINTS = 10


def find_peaks(heatmap: np.ndarray, sigma: float = 3.0,
               threshold: float = THRE_PEAK) -> List[List[Tuple]]:
    """Per-part local maxima of the (H, W, 19) heatmap: for each of the 18
    parts a list of (x, y, score, global_peak_id). Scores are read from the
    unsmoothed map (the smoothing only localises)."""
    from scipy.ndimage import gaussian_filter

    all_peaks: List[List[Tuple]] = []
    counter = 0
    for part in range(18):
        raw = heatmap[:, :, part]
        smooth = gaussian_filter(raw, sigma=sigma)
        shifted = np.full((4,) + smooth.shape, -np.inf, smooth.dtype)
        shifted[0, 1:, :] = smooth[:-1, :]
        shifted[1, :-1, :] = smooth[1:, :]
        shifted[2, :, 1:] = smooth[:, :-1]
        shifted[3, :, :-1] = smooth[:, 1:]
        is_peak = (smooth >= shifted).all(axis=0) & (smooth > threshold)
        ys, xs = np.nonzero(is_peak)
        peaks = [(int(x), int(y), float(raw[y, x]), counter + i)
                 for i, (x, y) in enumerate(zip(xs, ys))]
        counter += len(peaks)
        all_peaks.append(peaks)
    return all_peaks


def _limb_score(paf_xy: np.ndarray, a, b, img_h: int) -> Tuple[float, bool]:
    """PAF line integral from peak a to peak b over one limb's two-channel
    field: (score with the distance prior, whether both criteria hold)."""
    vec = np.array([b[0] - a[0], b[1] - a[1]], np.float32)
    norm = max(1e-3, float(np.hypot(vec[0], vec[1])))
    vec = vec / norm
    xs = np.round(np.linspace(a[0], b[0], N_MIDPOINTS)).astype(int)
    ys = np.round(np.linspace(a[1], b[1], N_MIDPOINTS)).astype(int)
    samples = paf_xy[ys, xs]  # (N, 2)
    scores = samples[:, 0] * vec[0] + samples[:, 1] * vec[1]
    prior = min(0.5 * img_h / norm - 1.0, 0.0)
    total = float(scores.mean()) + prior
    ok = (np.count_nonzero(scores > THRE_PAF) > 0.8 * N_MIDPOINTS
          and total > 0)
    return total, ok


def connect_limbs(paf: np.ndarray, all_peaks: List[List[Tuple]],
                  img_h: int) -> Tuple[list, list]:
    """Greedy per-limb bipartite matching by PAF score: (connections per
    limb, the limbs with a part that has no peak)."""
    connection_all: list = []
    special_k: list = []
    for k, (limb, chans) in enumerate(zip(LIMB_SEQ, MAP_IDX)):
        cand_a = all_peaks[limb[0] - 1]
        cand_b = all_peaks[limb[1] - 1]
        if not cand_a or not cand_b:
            special_k.append(k)
            connection_all.append([])
            continue
        paf_xy = paf[:, :, [chans[0] - 19, chans[1] - 19]]
        candidates = []
        for i, a in enumerate(cand_a):
            for j, b in enumerate(cand_b):
                score, ok = _limb_score(paf_xy, a, b, img_h)
                if ok:
                    candidates.append((i, j, score))
        candidates.sort(key=lambda c: c[2], reverse=True)
        connection = []
        used_i, used_j = set(), set()
        for i, j, score in candidates:
            if i in used_i or j in used_j:
                continue
            connection.append((cand_a[i][3], cand_b[j][3], score, i, j))
            used_i.add(i)
            used_j.add(j)
            if len(connection) >= min(len(cand_a), len(cand_b)):
                break
        connection_all.append(connection)
    return connection_all, special_k


def assemble_people(all_peaks: List[List[Tuple]], connection_all: list,
                    special_k: list) -> Tuple[np.ndarray, np.ndarray]:
    """Merge limb connections into per-person keypoint rows: (candidate
    (P, 4) [x, y, score, id], subset (N, 20): 18 peak indices, the total
    score and the part count). People with under 4 parts or a mean score
    under 0.4 are dropped."""
    candidate = np.array([p for part in all_peaks for p in part],
                         dtype=np.float64).reshape(-1, 4)
    subset = -1 * np.ones((0, 20))
    for k in range(len(MAP_IDX)):
        if k in special_k:
            continue
        idx_a, idx_b = LIMB_SEQ[k][0] - 1, LIMB_SEQ[k][1] - 1
        for peak_a, peak_b, score, _, _ in connection_all[k]:
            found_rows = [j for j in range(len(subset))
                          if subset[j][idx_a] == peak_a
                          or subset[j][idx_b] == peak_b][:2]
            if len(found_rows) == 1:
                j = found_rows[0]
                if subset[j][idx_b] != peak_b:
                    subset[j][idx_b] = peak_b
                    subset[j][-1] += 1
                    subset[j][-2] += candidate[int(peak_b), 2] + score
            elif len(found_rows) == 2:
                j1, j2 = found_rows
                membership = ((subset[j1] >= 0).astype(int)
                              + (subset[j2] >= 0).astype(int))[:-2]
                if not np.any(membership == 2):  # disjoint: merge
                    subset[j1][:-2] += subset[j2][:-2] + 1
                    subset[j1][-2:] += subset[j2][-2:]
                    subset[j1][-2] += score
                    subset = np.delete(subset, j2, 0)
                else:
                    subset[j1][idx_b] = peak_b
                    subset[j1][-1] += 1
                    subset[j1][-2] += candidate[int(peak_b), 2] + score
            elif k < 17:
                row = -1 * np.ones(20)
                row[idx_a], row[idx_b] = peak_a, peak_b
                row[-1] = 2
                row[-2] = (candidate[int(peak_a), 2]
                           + candidate[int(peak_b), 2] + score)
                subset = np.vstack([subset, row])
    keep = [i for i in range(len(subset))
            if subset[i][-1] >= 4 and subset[i][-2] / subset[i][-1] >= 0.4]
    return candidate, subset[keep]


def draw_bodypose(height: int, width: int, candidate: np.ndarray,
                  subset: np.ndarray) -> np.ndarray:
    """The 18-keypoint skeleton on black: limb ellipses at 0.6 alpha, then
    joint circles (OpenCV's ``ellipse2Poly``, ``fillConvexPoly``,
    ``addWeighted`` and ``circle``, from ``tasks.drawing`` and
    ``tasks.imgproc``)."""
    canvas = np.zeros((height, width, 3), np.uint8)
    stickwidth = 4
    for i in range(17):
        for person in subset:
            pair = person[np.array(LIMB_SEQ[i]) - 1]
            if -1 in pair:
                continue
            xs = candidate[pair.astype(int), 0]
            ys = candidate[pair.astype(int), 1]
            mx, my = xs.mean(), ys.mean()
            length = float(np.hypot(xs[0] - xs[1], ys[0] - ys[1]))
            angle = math.degrees(math.atan2(ys[0] - ys[1], xs[0] - xs[1]))
            polygon = drawing.ellipse2poly((int(mx), int(my)),
                                           (int(length / 2), stickwidth),
                                           int(angle), 0, 360, 1)
            overlay = canvas.copy()
            drawing.fill_convex_poly(overlay, polygon, COLORS[i])
            canvas = imgproc.add_weighted(canvas, 0.4, overlay, 0.6, 0)
    for i in range(18):
        for person in subset:
            idx = int(person[i])
            if idx == -1:
                continue
            x, y = candidate[idx][:2]
            drawing.circle(canvas, (int(x), int(y)), 4, COLORS[i])
    return canvas


def network_shape(h0: int, w0: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((h, w) of the image at the 368-boxsize scale 0.5 * 368 / h0, as
    OpenCV rounds it; (H, W) of the network input: h padded to the stride,
    w to the 64-pixel width bucket, which bounds the shapes a server sees)."""
    scale = 0.5 * BOXSIZE / h0
    h, w = int(np.rint(h0 * scale)), int(np.rint(w0 * scale))
    return (h, w), (h + (-h) % STRIDE, w + (-w) % WIDTH_BUCKET)


def network_tensor(image_rgb: np.ndarray,
                   device) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(x (1, H, W, 3) fp32 on ``device``, the scaled image's (h, w)): the
    image in BGR at the 368-boxsize scale (bicubic, OpenCV's uint8
    arithmetic, on ``device``), padded with 128 to ``network_shape``, as
    ``x / 256 - 0.5``."""
    ori = torch.as_tensor(np.ascontiguousarray(image_rgb[:, :, ::-1]),
                          device=device)  # the published model is BGR-trained
    scale = 0.5 * BOXSIZE / ori.shape[0]
    scaled = imgproc.resize(ori, fx=scale, fy=scale, interpolation=imgproc.INTER_CUBIC)
    h, w = scaled.shape[:2]
    padded = torch.nn.functional.pad(
        scaled.float().permute(2, 0, 1), (0, (-w) % WIDTH_BUCKET, 0, (-h) % STRIDE),
        value=PAD_VALUE).permute(1, 2, 0)
    return padded[None] / 256.0 - 0.5, (h, w)


def upsample_fields(paf, heat, scaled_hw: Tuple[int, int],
                    image_hw: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """One image's fields ((H/8, W/8, 38) and (H/8, W/8, 19), numpy or
    tensors) at the image's size, as numpy: upsampled x8 (bicubic, on the
    fields' device), the pad dropped, resized to the image."""
    (h, w), (h0, w0) = scaled_hw, image_hw

    def upsample(field):
        field = imgproc.resize(field, fx=STRIDE, fy=STRIDE,
                               interpolation=imgproc.INTER_CUBIC)[:h, :w]
        field = imgproc.resize(field, (w0, h0), interpolation=imgproc.INTER_CUBIC)
        return field.cpu().numpy() if isinstance(field, torch.Tensor) else field

    return upsample(paf), upsample(heat)


def decode(paf, heat, scaled_hw: Tuple[int, int],
           image_hw: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """(candidate, subset) from one image's fields: ``upsample_fields``,
    then peaks, limbs and people on the host."""
    paf_map, heatmap = upsample_fields(paf, heat, scaled_hw, image_hw)
    return decode_fields(paf_map, heatmap, image_hw[0])


def decode_fields(paf_map: np.ndarray, heatmap: np.ndarray,
                  img_h: int) -> Tuple[np.ndarray, np.ndarray]:
    """(candidate, subset) from fields already at the image's size."""
    all_peaks = find_peaks(heatmap)
    connections, special_k = connect_limbs(paf_map, all_peaks, img_h)
    return assemble_people(all_peaks, connections, special_k)


class OpenposeBodyPreprocessor:
    """'pose' control map: uint8 RGB image -> uint8 RGB skeleton.

    ``state`` is ``body_pose_model.pth``'s state dict (flat Caffe names, a
    ``model0.`` / ``model{s}_{b}.`` prefix accepted), or ``checkpoint`` its
    path. The network runs on ``device`` in fp32."""

    def __init__(self, state=None, checkpoint: Optional[str] = None,
                 device="cuda"):
        from powerpaint_tpu_torch.io.weights import load_annotator

        self.device = torch.device(device)
        self.model = load_annotator("bodypose", state, checkpoint=checkpoint,
                                    device=self.device)

    def network_tensor(self, image_rgb: np.ndarray):
        """``network_tensor`` of the image on this preprocessor's device."""
        return network_tensor(image_rgb, self.device)

    def network_input(self, image_rgb: np.ndarray):
        """``network_tensor`` as numpy."""
        x, hw = self.network_tensor(image_rgb)
        return x.cpu().numpy(), hw

    @torch.no_grad()
    def fields(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """(PAF, heatmap) of the first image of x, fp32 on the device."""
        paf, heat = self.model(torch.as_tensor(x, device=self.device))
        return paf[0].float(), heat[0].float()

    def forward(self, x) -> Tuple[np.ndarray, np.ndarray]:
        """(PAF, heatmap) of the first image of x, as float32 numpy."""
        paf, heat = self.fields(x)
        return paf.cpu().numpy(), heat.cpu().numpy()

    def estimate(self, image_rgb: np.ndarray):
        """(candidate, subset) for a uint8 RGB (H, W, 3) image; the fields
        stay on the device until they are at the image's size."""
        x, scaled_hw = self.network_tensor(image_rgb)
        paf, heat = self.fields(x)
        return decode(paf, heat, scaled_hw, image_rgb.shape[:2])

    def __call__(self, image_rgb: np.ndarray) -> np.ndarray:
        candidate, subset = self.estimate(image_rgb)
        h0, w0 = image_rgb.shape[:2]
        return draw_bodypose(h0, w0, candidate, subset)
