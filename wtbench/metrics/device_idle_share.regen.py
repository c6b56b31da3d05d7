"""Percent of the traced window in which no operation ran on the device."""

from wtbench.metrics import idle_share


def read(run):
    return idle_share(run)
