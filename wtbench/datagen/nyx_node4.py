"""One node's octant of the Nyx snapshot: ``nyx_rank64``'s generator at
the configuration's own ``cells`` and snapshots."""

from wtbench.datagen.nyx_rank64 import generate  # noqa: F401
