"""``h2d_s_per_gb.bundle``, read in the regen cell."""

from wtbench.metrics import load

read = load("h2d_s_per_gb.bundle")
