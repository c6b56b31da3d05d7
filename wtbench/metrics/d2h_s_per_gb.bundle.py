"""Seconds of the device step spent in the device-to-host copies, which
wait for the kernels (span ``engine.d2h``), the pipeline's
``d2h_seconds``, per GB of float32 boxes of the traced window."""

from wtbench.spans import s_per_gb


def read(run):
    return s_per_gb(run, "d2h_seconds")
