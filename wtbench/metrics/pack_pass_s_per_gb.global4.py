"""Seconds of the global mode's second pass (the cached coefficients
packed at the one threshold: RLE, xz, member writes; span
``compress.global_pass2``, ``global_pass2_seconds``), summed over the
ranks, per GB of the node's float32 boxes of the traced window."""

from wtbench.spans import s_per_gb


def read(run):
    return s_per_gb(run, "global_pass2_seconds")
