"""Seconds of copying each bucket's regenerated boxes into the
per-box arrays a timestep yields (span ``decompress.assemble``,
``assemble_seconds``) per GB of float32 boxes of the traced window."""

from wtbench.spans import s_per_gb


def read(run):
    return s_per_gb(run, "assemble_seconds")
