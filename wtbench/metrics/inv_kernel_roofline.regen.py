"""The inverse Haar kernel's share of the memory roofline: every box's
coefficients read once and the box written once, at the card's peak
bandwidth, over the device time of the kernel's launches
(``csrc/pyramid.cu``)."""

from wtbench.metrics import roofline

KERNELS = ("pyramid_inverse_scale_kernel",)


def read(run):
    return roofline(run, KERNELS, 2 * run.total("f32_bytes"))
