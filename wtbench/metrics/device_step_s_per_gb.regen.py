"""Seconds of the device step as the host sees it (H2D, inverse kernel,
D2H), the pipeline's ``device_seconds``, per GB of float32 boxes of the
traced window."""

from wtbench.metrics import s_per_gb


def read(run):
    return s_per_gb(run, "device_seconds")
