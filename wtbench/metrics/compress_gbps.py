"""Float32 box bytes of every compress pass of the window over the wall of
those passes."""

from wtbench.metrics import gbps


def read(run):
    return gbps(run) if run.produces == "archive" else None
