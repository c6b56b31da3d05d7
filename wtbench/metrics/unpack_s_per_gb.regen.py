"""Seconds of the host unpack (member read, xz decode, RLE scatter), the
pipeline's ``unpack_seconds``, per GB of float32 boxes of the traced
window."""

from wtbench.metrics import s_per_gb


def read(run):
    return s_per_gb(run, "unpack_seconds")
