"""``pack_cores.compress``, read in the bundle cell, where it is filed
under ``archive_ratio`` (see PERF.md)."""

from wtbench.metrics import load

read = load("pack_cores.compress")
