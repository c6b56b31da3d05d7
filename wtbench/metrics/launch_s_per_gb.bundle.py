"""Seconds of the device step spent in the kernel wrappers' calls
(span ``engine.launch``), the pipeline's ``launch_seconds``, per GB
of float32 boxes of the traced window."""

from wtbench.spans import s_per_gb


def read(run):
    return s_per_gb(run, "launch_seconds")
