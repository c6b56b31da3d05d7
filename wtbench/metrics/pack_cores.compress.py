"""Cores the host pack kept busy: the thread CPU seconds of its members
(span ``pack.member``, stat ``pack_cpu_seconds``) over the wall of the pack
calls (span ``pack.batch``, ``pack_seconds``)."""

from wtbench.spans import ratio


def read(run):
    return ratio(run, "pack_cpu_seconds", "pack_seconds")
