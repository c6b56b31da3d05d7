"""Seconds of the device step spent in the pageable host-to-device
copies (span ``engine.h2d``), the pipeline's ``h2d_seconds``, per GB
of float32 boxes of the traced window."""

from wtbench.spans import s_per_gb


def read(run):
    return s_per_gb(run, "h2d_seconds")
