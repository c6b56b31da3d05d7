"""Float32 box bytes regenerated into host memory by the window's passes
over their wall."""

from wtbench.metrics import gbps


def read(run):
    return gbps(run) if run.produces == "boxes" else None
