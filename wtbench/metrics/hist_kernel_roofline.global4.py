"""The fused forward and histogram kernel's (K6's) share of the memory
roofline on rank 0: its device time in rank 0's trace
(``csrc/pyramid.cu``'s ``pyramid_forward_scale_kernel`` in histogram
mode, and ``reduce_partials_kernel`` were it launched) against rank 0's
bytes at the card's peak bandwidth.

The bytes of a pass, each read or written once: scale s of the pyramid
reads its corner, 1/8**s of rank 0's boxes, and writes as much (scale 0
the boxes themselves, scale 1 the 1/8 corner), and each launch writes its
2048 int64 counts.  Rank 0's boxes are its ``input_bytes``, the items it
packed.  The histogram's per-block flushes are atomics into those counts,
not counted again.  With the default globalcache every coefficient of
this configuration stays cached, so the kernel runs once a pass."""

from wtbench.metrics import roofline

KERNELS = ("pyramid_forward_scale_kernel", "reduce_partials_kernel")
HIST_BYTES = 2048 * 8


def nbytes(record) -> float:
    share = sum(2.0 / 8 ** s for s in range(int(record["scales"])))
    return share * record["rank0_f32_bytes"] + \
        HIST_BYTES * record["rank0_hist_calls"]


def read(run):
    if not run.records or "rank0_f32_bytes" not in run.records[0]:
        return None
    return roofline(run, KERNELS, sum(nbytes(r) for r in run.records))
