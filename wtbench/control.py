"""The control: the reference put in the program's place and computed in
the next precision below float32, judged by the same comparison as a run.

    python3 -m wtbench.control --workload NAME --seeds 1 2 3

For each seed it makes the cell's dataset at the cell's own size, lets the
reference produce in bfloat16 what a run's check reads (every member of
an archive, every box of a pass), through the ``control`` of the cell's
traffic driver, and prints the numbers the check compares.  A sound comparison reads the control as not
correct.  The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from wtbench import datagen, drivers, spec
from wtbench.reference import check

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def control_numbers(bench, cell: dict, seed: int, device,
                    dtype=torch.bfloat16) -> dict:
    traffic = bench.traffic(cell["traffic"])
    ds = datagen.generate(cell["config"], bench.config(cell["config"]), seed,
                          device)
    return drivers.load(traffic["kind"]).control(ds, traffic, seed, device,
                                                 dtype)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bfloat16")
    args = ap.parse_args(argv)
    bench = spec.Bench()
    device = "cuda" if torch.cuda.is_available() else "cpu"
    cell = bench.cell(args.workload)
    limits = drivers.load(bench.traffic(cell["traffic"])["kind"]).LIMITS
    for seed in args.seeds:
        numbers = control_numbers(bench, cell, seed, device,
                                  DTYPES[args.dtype])
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "dtype": args.dtype, "device": device,
                          "correct": check.verdict(numbers, limits),
                          "numbers": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
