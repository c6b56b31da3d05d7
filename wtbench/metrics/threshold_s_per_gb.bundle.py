"""Seconds of the device step spent in the host's
``resolve_signed_absmax`` and ``exact_threshold32`` (span
``engine.threshold``), the pipeline's ``threshold_seconds``, per GB
of float32 boxes of the traced window."""

from wtbench.spans import s_per_gb


def read(run):
    return s_per_gb(run, "threshold_seconds")
