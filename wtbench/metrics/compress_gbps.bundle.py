"""Float32 box bytes of every compress pass of the traced window over the
wall of those passes, in the cells where ``compress_gbps`` swings with the
host too widely to be held end to end."""

from wtbench.metrics import gbps


def read(run):
    return gbps(run) if run.produces == "archive" else None
