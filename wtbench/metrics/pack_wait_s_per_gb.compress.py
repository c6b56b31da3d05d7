"""Seconds of waiting on the host pack (RLE, xz, member write), the
pipeline's ``pack_wait_seconds``, per GB of float32 boxes of the traced
window."""

from wtbench.metrics import s_per_gb


def read(run):
    return s_per_gb(run, "pack_wait_seconds")
