"""The stride-1 3x3 convolutions (every ResNet unit's two, with the
GroupNorm + SiLU before them, and every upsampler's) against the kernels
named ``conv3x3``: see ``work.roofline_share``."""

from benchmark.work import roofline_share


def read(run):
    return roofline_share(run, "conv", "conv3x3")
