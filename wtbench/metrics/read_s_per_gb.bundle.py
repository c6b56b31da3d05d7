"""``read_s_per_gb.compress``, read in the bundle cell, where it is filed under
``archive_ratio`` (see PERF.md)."""

from wtbench.metrics import load

read = load("read_s_per_gb.compress")
