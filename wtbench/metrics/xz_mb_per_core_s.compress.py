"""xz's rate on one core: the payload bytes the pack hands xz
(``xz_in_bytes``) over the thread CPU seconds xz took (span ``pack.xz``,
``xz_cpu_seconds``), MB/s."""

from wtbench.spans import ratio


def read(run):
    return ratio(run, "xz_in_bytes", "xz_cpu_seconds", 1e-6)
