"""Float32 box bytes of the node's compress passes over the wall of those
passes (each from rank 0's broadcast to the barrier after the slowest
rank), in the traced window: the four-rank cell's rate, per layer, as its
runs drift with the host by more than the end-to-end bound admits."""

from wtbench.metrics import gbps


def read(run):
    return gbps(run) if run.produces == "archive" else None
