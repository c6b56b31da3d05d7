"""Seconds of the global mode's first pass (read, the fused forward and
histogram, the D2H of the coefficients it caches; span
``compress.global_pass1``, ``global_pass1_seconds``), summed over the
ranks, per GB of the node's float32 boxes of the traced window."""

from wtbench.spans import s_per_gb


def read(run):
    return s_per_gb(run, "global_pass1_seconds")
