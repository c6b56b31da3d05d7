"""Datasets: a configuration's generator, found by name, and the frozen
plotfile writer.

A generator is ``datagen/<config>.py`` with ``generate(cfg, seed, device)
-> Dataset``: the boxes as host float32 arrays, made from the seed on
``device``.  The same seed gives the same boxes.
"""

from __future__ import annotations

import importlib.util
import os
from dataclasses import dataclass

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclass
class Snapshot:
    """One plotfile: per level the boxes ``(C, X, Y, Z)`` float32 and their
    lower corners in that level's index space."""

    name: str
    time: float
    step: int
    boxes: list         # [level] -> [box] -> np.ndarray (C, X, Y, Z) f32
    locations: list     # [level] -> [box] -> (x, y, z)


@dataclass
class Dataset:
    components: list    # field names, in plotfile-Header order
    base_dims: tuple    # level-0 domain cells
    ref_ratio: int
    prob_lo: tuple
    prob_hi: tuple
    snapshots: list

    @property
    def n_levels(self) -> int:
        return len(self.snapshots[0].boxes)

    def items(self):
        """Every codec item: ``(t, level, comp, box)`` with comp the
        Header index, in the order the archive names them."""
        for t, s in enumerate(self.snapshots):
            for lev, boxes in enumerate(s.boxes):
                for b in range(len(boxes)):
                    for c in range(len(self.components)):
                        yield (t, lev, c, b)

    def item(self, key) -> np.ndarray:
        t, lev, c, b = key
        return self.snapshots[t].boxes[lev][b][c]

    def f32_bytes(self) -> int:
        """Bytes of float32 box data of every snapshot."""
        return sum(a.nbytes for s in self.snapshots for boxes in s.boxes
                   for a in boxes)


def generate(config: str, cfg: dict, seed: int, device) -> Dataset:
    """Run ``datagen/<config>.py``'s ``generate``."""
    path = os.path.join(HERE, f"{config}.py")
    spec = importlib.util.spec_from_file_location(
        f"wtbench.datagen.{config}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.generate(cfg, int(seed), device)


def as_host(t) -> np.ndarray:
    """A device tensor as a contiguous host float32 array."""
    return np.ascontiguousarray(t.detach().to("cpu").numpy(), np.float32)
