"""Seconds of the plotfile read (FAB f64 to f32 boxes), the pipeline's
``read_seconds``, per GB of float32 boxes of the traced window."""

from wtbench.metrics import s_per_gb


def read(run):
    return s_per_gb(run, "read_seconds")
