"""Every self- and cross-attention of the UNet and the branch and the VAE's
mid attention against the kernels named ``flash_``: see ``work.roofline_share``."""

from benchmark.work import roofline_share


def read(run):
    return roofline_share(run, "attention", "flash_")
