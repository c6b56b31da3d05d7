"""Cores the host unpack kept busy: the thread CPU seconds of its members
(span ``unpack.member``, ``unpack_cpu_seconds``) over the wall of the
unpack stage (span ``decompress.unpack``, ``unpack_seconds``)."""

from wtbench.spans import ratio


def read(run):
    return ratio(run, "unpack_cpu_seconds", "unpack_seconds")
