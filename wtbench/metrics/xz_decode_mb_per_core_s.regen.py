"""xz's decode rate on one core: the payload bytes xz gave back
(``xz_decoded_bytes``) over the thread CPU seconds it took (span
``unpack.xz``, ``xz_decode_cpu_seconds``), MB/s."""

from wtbench.spans import ratio


def read(run):
    return ratio(run, "xz_decoded_bytes", "xz_decode_cpu_seconds", 1e-6)
