"""``xz_mb_per_core_s.compress``, read in the bundle cell, where it is
filed under ``archive_ratio`` (see PERF.md)."""

from wtbench.metrics import load

read = load("xz_mb_per_core_s.compress")
