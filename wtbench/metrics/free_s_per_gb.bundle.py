"""Seconds of the device step spent dropping its device tensors (span
``engine.free``): freeing one takes the GIL anew, which the host packer's
workers hold; the pipeline's ``free_seconds``, per GB of float32 boxes of
the traced window."""

from wtbench.spans import s_per_gb


def read(run):
    return s_per_gb(run, "free_seconds")
