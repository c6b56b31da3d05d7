"""Standalone plotfile read and write stage rates of the port's host I/O.

    python -m wavelet_tpu_torch.scripts.bench_plotfile_io [--device cuda|cpu]
        [--n-scale 1.0] [--root DIR]
        [--out bench_results_torch/plotfile_io.json]

The counterpart of the JAX package's ``scripts/bench_plotfile_io.py``, on
the port's ``io/plotfile``: the writer at f64 and f32 outprec and the
reader, at 64 boxes of 64^3 and 16 of 128^3 (two components;
``--n-scale F`` multiplies both counts, at least one box).  The work is host-only: ``--device``
only names the card in the JSON (and ``cuda``, the default, needs one).
Files go in a directory of the run's own made under ``--root`` (default:
the temporary directory) and removed at the end.  Reference anchors:
writeplotfile.cpp:118-231 (writer), preprocess.cpp:311-377 (reader).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

from wavelet_tpu_torch.io import plotfile
from wavelet_tpu_torch.scripts import harness

__all__ = ["synth_level", "bench_write", "bench_read", "main"]

OUT = os.path.join("bench_results_torch", "plotfile_io.json")
CASES = ((64, 64), (128, 16))      # (box edge, boxes)


def synth_level(n_boxes, dim, ncomp, seed):
    rng = np.random.default_rng(seed)
    boxes = [rng.standard_normal((ncomp, dim, dim, dim)).astype(np.float32)
             for _ in range(n_boxes)]
    locs, dims = [], []
    side = int(np.ceil(n_boxes ** (1 / 3)))
    for b in range(n_boxes):
        i, j, k = b % side, (b // side) % side, b // (side * side)
        locs.append((i * dim, j * dim, k * dim))
        dims.append((dim, dim, dim))
    return boxes, locs, dims


def bench_write(d, boxes, locs, dims, ncomp, precision, reps=3):
    src_bytes = sum(b.nbytes for b in boxes)
    best = None
    for r in range(reps):
        out = os.path.join(d, f"plt_{precision}_{r}")
        t0 = time.perf_counter()
        side = int(np.ceil(len(boxes) ** (1 / 3)))
        dim = dims[0][0]
        plotfile.write_plotfile(
            out, [boxes], [locs], [dims],
            [f"c{i}" for i in range(ncomp)], time=0.5,
            prob_lo=(0.0, 0.0, 0.0), prob_hi=(1.0, 1.0, 1.0),
            ref_ratios=(2, 2, 2),
            base_dims=(side * dim, side * dim, side * dim),
            level_steps=[0], precision=precision)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    disk = sum(os.path.getsize(os.path.join(dp, fn))
               for dp, _, fns in os.walk(out) for fn in fns)
    return {"src_gbps": round(src_bytes / best / 1e9, 3),
            "disk_gbps": round(disk / best / 1e9, 3),
            "src_bytes": src_bytes, "disk_bytes": disk}, out


def bench_read(plt_dir, ncomp, src_bytes, reps=3):
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        lb = plotfile.read_level(plt_dir, 0, list(range(ncomp)))
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    got = sum(b.nbytes for b in lb.boxes)
    return {"f32_gbps": round(got / best / 1e9, 3), "f32_bytes": got}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m wavelet_tpu_torch.scripts.bench_plotfile_io",
        description="Plotfile read/write rates of wavelet_tpu_torch.")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) | cpu: the label of the JSON")
    ap.add_argument("--n-scale", type=float, default=1.0,
                    help="multiplies each case's box count (at least 1)")
    ap.add_argument("--root", default=None,
                    help="the directory under which this run makes its own "
                         "(default: the temporary directory)")
    ap.add_argument("--out", default=OUT)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    a = parse_args(argv)
    dev, card = harness.device_card(a.device)
    out = {"timestamp": time.strftime("%Y-%m-%d %H:%M:%S"), "card": card,
           "device": dev.type, "n_scale": a.n_scale, "cases": {}}
    with harness.private_dir(a.root, "wtc_plotfile_io_") as d:
        for dim, n in CASES:
            n_boxes = max(1, round(n * a.n_scale))
            boxes, locs, dims = synth_level(n_boxes, dim, ncomp := 2,
                                            seed=dim)
            case = {}
            for precision in ("f64", "f32"):
                w, plt_dir = bench_write(d, boxes, locs, dims, ncomp,
                                         precision)
                case[f"write_{precision}"] = w
                case[f"read_{precision}"] = bench_read(plt_dir, ncomp,
                                                       w["src_bytes"])
            out["cases"][f"{dim}^3_x{n_boxes}"] = case
            print(f"{dim}^3 x {n_boxes}:", json.dumps(case), flush=True)
    harness.write_json(a.out, out)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
