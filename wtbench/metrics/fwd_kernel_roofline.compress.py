"""The forward Haar kernel's share of the memory roofline: every box read
once, its coefficients written once and two extrema a box, at the card's
peak bandwidth, over the device time of the kernel's launches
(``csrc/pyramid.cu``: the one-scale pass and its extrema reduction)."""

from wtbench.metrics import roofline

KERNELS = ("pyramid_forward_scale_kernel", "reduce_partials_kernel")


def read(run):
    nbytes = 2 * run.total("f32_bytes") + 8 * run.total("items")
    return roofline(run, KERNELS, nbytes)
