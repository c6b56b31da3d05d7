"""Scaling of the collective compress steps over meshes of 1..N entries.

    python -m wavelet_tpu_torch.scripts.scaling_bench [--device cuda|cpu]
        [--devices 8] [--repeat] [--per-device-boxes 8] [--dim 32]
        [--iters 10] [--out bench_results_torch/scaling.json]
        [--coordinator HOST:PORT --processes P --processid I]

The counterpart of the JAX package's ``scripts/scaling_bench.py``:
``distributed.make_parity_compress_step`` (K1 per entry, no collective)
and ``make_global_compress_step`` (K6 per entry, the histograms summed,
the threshold on the card) over meshes of 1, 2, 4, ... entries, each fed
``per-device-boxes`` boxes per entry.  Per mesh size: GB/s in total and
per entry (the median of 3 reps, each the mean of ``iters`` calls on fresh
inputs), efficiency against linear scaling from one entry, and a check
that every mesh gives mesh 1's outputs on one common batch (bitwise; the
global step's kept count, since its limbs are per-entry sums).  The steps
take and return host arrays, so a call includes its H2D and D2H copies.

Meshes: ``--device cuda --devices N`` takes this process's cards
(``mesh.local_cards``, which refuses cards the host lacks); ``--repeat``
repeats ``cuda:0`` N times instead; ``--device cpu --devices N`` builds N
CPU entries.  Entries that repeat one device share its memory and cores,
so their "efficiency" measures the overhead of splitting on one device,
not scaling: the JSON counts the distinct devices and says so.  With
``--coordinator`` the process joins a gloo group first, and each mesh is
the global mesh of every process's entries (every process runs the same
command with its own ``--processid``; the group is torn down at exit).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from wavelet_tpu_torch.runtime import distributed
from wavelet_tpu_torch.runtime import mesh as mesh_lib
from wavelet_tpu_torch.scripts import harness

__all__ = ["mesh_entries", "run", "main"]

OUT = os.path.join("bench_results_torch", "scaling.json")
KEEP_FRACTION = 0.02


def mesh_entries(device: str, n: int, repeat: bool) -> list:
    """This process's ``n`` mesh entries."""
    if device == "cpu":
        return ["cpu"] * n
    if repeat:
        return [mesh_lib.resolve_device("cuda:0")] * n
    return mesh_lib.local_cards(n)


def _mesh(entries):
    local = mesh_lib.data_mesh(entries)
    if mesh_lib.process_count() > 1:
        return mesh_lib.global_mesh(local)
    return local


def _same(a, b) -> bool:
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and a.tobytes() == b.tobytes()


def run(device: str = "cuda", devices: int = 8, repeat: bool = False,
        per_device_boxes: int = 8, dim: int = 32, iters: int = 10,
        reps: int = 3) -> dict:
    entries = mesh_entries(device, devices, repeat)
    distinct = len({str(d) for d in entries})
    d = dim
    sizes = [s for s in (1, 2, 4, 8, 16, 32) if s <= devices]
    procs = mesh_lib.process_count()
    results = {"device": device, "entries": [str(e) for e in entries],
               "distinct_devices": distinct, "processes": procs, "dim": d,
               "per_device_boxes": per_device_boxes, "iters": iters,
               "meshes": {}}
    if distinct < devices or device == "cpu":
        results["note"] = (
            "entries share one device's memory and cores (CPU entries share "
            "the host's), so 'scaling_efficiency' measures the overhead of "
            "splitting a batch on one device, NOT scaling across devices")
    # one common batch for the output check: the largest mesh's size
    check = np.random.default_rng(7).standard_normal(
        (per_device_boxes * max(sizes) * procs, d, d, d)).astype(np.float32)
    ref = {}
    base = {}
    for s in sizes:
        mesh = _mesh(entries[:s])
        steps = {"parity": distributed.make_parity_compress_step(mesh),
                 "global": distributed.make_global_compress_step(
                     mesh, KEEP_FRACTION)}
        n = per_device_boxes * mesh.size
        nbytes = n * d ** 3 * 4
        row = {"mesh_size": mesh.size}
        for name, step in steps.items():
            out = step(check)
            got = [out[0], out[1]] + ([distributed.kept_count(out[2])]
                                      if name == "global" else [])
            if s == sizes[0]:
                ref[name] = got
            elif not all(_same(a, b) for a, b in zip(got, ref[name])):
                raise AssertionError(f"mesh of {mesh.size} entries: the "
                                     f"{name} step's outputs differ from "
                                     "the one-entry mesh's")

            def one_rep(seed):
                xs = [np.random.default_rng(seed + i).standard_normal(
                    (n, d, d, d)).astype(np.float32) for i in range(iters)]
                t0 = time.perf_counter()
                for x in xs:
                    step(x)
                return (time.perf_counter() - t0) / iters

            step(np.zeros((n, d, d, d), np.float32))       # warm-up
            rates = [nbytes / 1e9 / one_rep(1000 * (rep + 1))
                     for rep in range(reps)]
            rate = float(np.median(rates))
            base.setdefault(name, rate / mesh.size)
            row[name] = {"gbps_total": round(rate, 4),
                         "gbps_per_entry": round(rate / mesh.size, 4),
                         "scaling_efficiency": round(
                             rate / (base[name] * mesh.size), 4),
                         "gbps_reps": [round(r, 4) for r in rates]}
        row["outputs_equal_to_mesh1"] = True
        results["meshes"][str(mesh.size)] = row
        print(f"mesh={mesh.size:2d}: parity "
              f"{row['parity']['gbps_total']:8.3f} GB/s "
              f"({row['parity']['scaling_efficiency']:.1%}), global "
              f"{row['global']['gbps_total']:8.3f} GB/s "
              f"({row['global']['scaling_efficiency']:.1%})", flush=True)
    # collective volume per step: the parity step has none; the global
    # step all-reduces one int64 2048-bin histogram and the kept limbs
    # over gloo when the mesh spans processes
    results["gloo_bytes"] = dict(distributed.gloo_bytes)
    return results


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m wavelet_tpu_torch.scripts.scaling_bench",
        description="Scaling of the collective compress steps.")
    ap.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--repeat", action="store_true",
                    help="repeat cuda:0 instead of taking distinct cards")
    ap.add_argument("--per-device-boxes", type=int, default=8)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--coordinator", default=None, help="HOST:PORT")
    ap.add_argument("--processes", type=int, default=None)
    ap.add_argument("--processid", type=int, default=None)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    a = parse_args(argv)
    if a.coordinator is not None:
        mesh_lib.init_distributed(a.coordinator, a.processes, a.processid)
    results = run(a.device, a.devices, a.repeat, a.per_device_boxes, a.dim,
                  a.iters)
    if mesh_lib.process_index() == 0:
        harness.write_json(a.out, results)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
