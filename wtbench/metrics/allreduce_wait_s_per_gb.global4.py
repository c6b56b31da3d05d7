"""Seconds the ranks wait at the sum of their histograms (the gloo
``all_reduce``; span ``compress.allreduce``, ``allreduce_seconds``),
summed over the ranks, per GB of the node's float32 boxes of the traced
window: what the slowest rank's first pass costs the others."""

from wtbench.spans import s_per_gb


def read(run):
    return s_per_gb(run, "allreduce_seconds")
