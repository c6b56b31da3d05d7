"""Percent of the traced window in which no operation ran on rank 0's
card (the harness traces rank 0, the harness process)."""

from wtbench.metrics import idle_share


def read(run):
    return idle_share(run)
