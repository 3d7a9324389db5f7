"""Annotator networks for the ControlNet control maps: HED edges and the
OpenPose body cascade (the port of ``powerpaint_tpu/models/annotators.py``).

- ``HEDNetwork``: Holistically-Nested Edge Detection (Xie & Tu, ICCV 2015)
  in its VGG16 form, with the parameter names of ``network-bsds500.pth``
  after its ``module`` -> ``net`` rename (``netVggOne.0.weight``, ...).
- ``BodyPoseModel``: the CMU two-branch cascade (Cao et al., CVPR 2017), a
  VGG19 stem and six stages of a PAF branch (38 channels) and a heatmap
  branch (19), with ``body_pose_model.pth``'s flat Caffe layer names
  (``conv1_1.weight``, ``Mconv7_stage6_L2.bias``).

Both take NHWC. Their convs are plain convolutions with a bias, cuDNN on
the card, as the JAX package leaves them to XLA (no Pallas kernel). The
host-side OpenPose decode is ``tasks/pose.py``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from powerpaint_tpu_torch.models.layers import Conv2D

# Caffe-era BGR channel means stored with the published HED checkpoint;
# the reference deployment subtracts them from the RGB image as they are.
HED_BGR_MEANS = (104.00698793, 116.66876762, 122.67891434)


class MaxPool2x2(nn.Module):
    """2x2 / 2 max-pool on NHWC (VALID: an odd last row or column drops)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def _vgg_stage(cin: int, widths, pool: bool) -> nn.Sequential:
    layers = [MaxPool2x2()] if pool else []
    for c in widths:
        layers += [Conv2D(cin, c, 3, padding=1), nn.ReLU()]
        cin = c
    return nn.Sequential(*layers)


class HEDNetwork(nn.Module):
    """HED: VGG16 stages, a 1x1 score conv per stage, every score resized
    to the input (bilinear, half-pixel centres), a 1x1 fusion conv, sigmoid.

    Input (B, H, W, 3) in [0, 1], RGB: the reference deployment feeds RGB
    into the Caffe-trained network and subtracts the BGR-ordered means all
    the same, and the HED ControlNet was trained on those maps. Output
    (B, H, W, 1) edge probability."""

    def __init__(self):
        super().__init__()
        self.netVggOne = _vgg_stage(3, (64, 64), pool=False)
        self.netVggTwo = _vgg_stage(64, (128, 128), pool=True)
        self.netVggThr = _vgg_stage(128, (256, 256, 256), pool=True)
        self.netVggFou = _vgg_stage(256, (512, 512, 512), pool=True)
        self.netVggFiv = _vgg_stage(512, (512, 512, 512), pool=True)
        self.netScoreOne = Conv2D(64, 1, 1)
        self.netScoreTwo = Conv2D(128, 1, 1)
        self.netScoreThr = Conv2D(256, 1, 1)
        self.netScoreFou = Conv2D(512, 1, 1)
        self.netScoreFiv = Conv2D(512, 1, 1)
        self.netCombine = nn.Sequential(Conv2D(5, 1, 1), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1:3]
        dtype = self.netScoreOne.weight.dtype
        x = x.to(dtype) * 255.0 - x.new_tensor(HED_BGR_MEANS, dtype=dtype)
        scores = []
        for stage, score in (
                (self.netVggOne, self.netScoreOne), (self.netVggTwo, self.netScoreTwo),
                (self.netVggThr, self.netScoreThr), (self.netVggFou, self.netScoreFou),
                (self.netVggFiv, self.netScoreFiv)):
            x = stage(x)
            s = score(x).permute(0, 3, 1, 2)
            if s.shape[2:] != (h, w):
                s = F.interpolate(s, size=(h, w), mode="bilinear",
                                  align_corners=False)
            scores.append(s)
        return self.netCombine(torch.cat(scores, 1).permute(0, 2, 3, 1))


# (name, out_channels, kernel) of the stem; "pool" is a 2x2 max-pool. ReLU
# follows every conv.
BODY_STEM = (
    ("conv1_1", 64, 3), ("conv1_2", 64, 3), ("pool", 0, 0),
    ("conv2_1", 128, 3), ("conv2_2", 128, 3), ("pool", 0, 0),
    ("conv3_1", 256, 3), ("conv3_2", 256, 3), ("conv3_3", 256, 3),
    ("conv3_4", 256, 3), ("pool", 0, 0),
    ("conv4_1", 512, 3), ("conv4_2", 512, 3),
    ("conv4_3_CPM", 256, 3), ("conv4_4_CPM", 128, 3),
)
PAF_CHANNELS = 38
HEATMAP_CHANNELS = 19


def _stage1(suffix: str, out_c: int):
    """(name, cin, cout, kernel) of stage 1's branch; no ReLU on the last."""
    return ([(f"conv5_{i}_CPM_{suffix}", 128, 128, 3) for i in (1, 2, 3)]
            + [(f"conv5_4_CPM_{suffix}", 128, 512, 1),
               (f"conv5_5_CPM_{suffix}", 512, out_c, 1)])


def _stage_n(stage: int, suffix: str, out_c: int):
    cin = PAF_CHANNELS + HEATMAP_CHANNELS + 128
    return ([(f"Mconv1_stage{stage}_{suffix}", cin, 128, 7)]
            + [(f"Mconv{i}_stage{stage}_{suffix}", 128, 128, 7)
               for i in (2, 3, 4, 5)]
            + [(f"Mconv6_stage{stage}_{suffix}", 128, 128, 1),
               (f"Mconv7_stage{stage}_{suffix}", 128, out_c, 1)])


class BodyPoseModel(nn.Module):
    """CMU body-pose cascade: the stem, stage 1, then stages 2 to 6 on
    concat(PAF, heatmap, stem features).

    Input (B, H, W, 3) BGR normalised as ``x / 256 - 0.5`` (``tasks/pose``),
    H and W multiples of 8. Output (PAF (B, H/8, W/8, 38), heatmap
    (B, H/8, W/8, 19))."""

    def __init__(self):
        super().__init__()
        self.pool = MaxPool2x2()
        cin = 3
        for name, c, k in BODY_STEM:
            if name != "pool":
                self.add_module(name, Conv2D(cin, c, k, padding=(k - 1) // 2))
                cin = c
        self.branches = {}
        for stage in range(1, 7):
            for suffix, out_c in (("L1", PAF_CHANNELS), ("L2", HEATMAP_CHANNELS)):
                spec = (_stage1(suffix, out_c) if stage == 1
                        else _stage_n(stage, suffix, out_c))
                for name, ci, co, k in spec:
                    self.add_module(name, Conv2D(ci, co, k, padding=(k - 1) // 2))
                self.branches[stage, suffix] = [name for name, *_ in spec]

    def _branch(self, x: torch.Tensor, stage: int, suffix: str) -> torch.Tensor:
        names = self.branches[stage, suffix]
        for name in names[:-1]:
            x = F.relu(getattr(self, name)(x))
        return getattr(self, names[-1])(x)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x.to(self.conv1_1.weight.dtype)
        for name, _, _ in BODY_STEM:
            if name == "pool":
                x = self.pool(x)
            else:
                x = F.relu(getattr(self, name)(x))
        feat = x
        paf, heat = self._branch(feat, 1, "L1"), self._branch(feat, 1, "L2")
        for stage in range(2, 7):
            x = torch.cat([paf, heat, feat], dim=-1)
            paf, heat = self._branch(x, stage, "L1"), self._branch(x, stage, "L2")
        return paf, heat
