"""The benchmark at sizes a CPU test holds: the same files, with each
configuration's scale cut down."""

from __future__ import annotations

from wtbench import spec

TINY = {
    "nyx_rank64": {"cells": 32, "max_grid_size": 16},
    "sedov_amr4": {"base_cells": 16, "max_grid_size": 8,
                   "blocking_factor": 4, "levels": 3, "band_cells": 2},
}
CELLS = ["nyx_rank64.compress", "sedov_amr4.compress", "nyx_rank64.regen"]
SEED = 2 ** 31 + 977


class TinyBench(spec.Bench):
    def config(self, name: str) -> dict:
        cfg = super().config(name)
        cfg.update(TINY[name])
        return cfg


def run_cell(cell: str, seed: int = SEED, seconds: float = 0.3,
             trace: bool = False) -> dict:
    from wtbench import run

    bench = TinyBench()
    return run.execute(bench, bench.cell(cell), seed, seconds, trace, "cpu")
