"""Thread CPU seconds of the calling thread inside the device step (span
``compress.device_step``, ``device_cpu_seconds``) per GB of float32 boxes
of the traced window: the step's wall less this is time it waited (the
GIL, copies, synchronisation)."""

from wtbench.spans import s_per_gb


def read(run):
    return s_per_gb(run, "device_cpu_seconds")
