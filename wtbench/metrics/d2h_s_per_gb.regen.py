"""``d2h_s_per_gb.bundle``, read in the regen cell."""

from wtbench.metrics import load

read = load("d2h_s_per_gb.bundle")
