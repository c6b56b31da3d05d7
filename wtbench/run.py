"""Run one benchmark cell once and print its result as the last line.

    python3 -m wtbench.run --workload NAME --seed N --seconds S --trace 0|1

Set-up generates the configuration's dataset on the card from the seed,
writes it as plotfiles under a private directory in ``TMPDIR``, loads the
program and warms up the cell's shapes; then the window runs the cell's
traffic for at least ``--seconds``; then the outputs are judged against
the plain reference.  With ``--trace 0`` the metrics are the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics from a traced
window.  Without a card (or with fewer than the cell asks for) it prints
no result and exits 2.
"""

from __future__ import annotations

import time

_START = time.perf_counter()    # set-up is timed from the process's start

import argparse                 # noqa: E402
import gc                       # noqa: E402
import json                     # noqa: E402
import os                       # noqa: E402
import shutil                   # noqa: E402
import subprocess               # noqa: E402
import sys                      # noqa: E402
import tempfile                 # noqa: E402
from dataclasses import dataclass  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "wavelet_tpu")


@dataclass
class Context:
    dataset: object
    traffic: dict
    seed: int
    device: str
    work: str
    data_dir: str
    written: int = 0


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def execute(bench, cell: dict, seed: int, seconds: float, trace: bool,
            device: str, start: float = _START) -> dict:
    """Set-up, window and check of one cell on ``device``; -> the result
    dict (its ``checks`` key last)."""
    import torch

    from wtbench import datagen, drivers, metrics, peaks
    from wtbench import trace as trace_mod
    from wtbench.datagen import plotfile
    from wtbench.reference import check

    cfg = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    work = tempfile.mkdtemp(prefix="wtbench-")
    try:
        ds = datagen.generate(cell["config"], cfg, seed, device)
        data_dir = os.path.join(work, "data")
        ctx = Context(dataset=ds, traffic=traffic, seed=seed, device=device,
                      work=work, data_dir=data_dir)
        ctx.written += plotfile.write_dataset(data_dir, ds)
        kind = drivers.load(traffic["kind"])
        drv = kind.Driver(ctx)
        drv.setup()
        # flush set-up's writes now, so that their write-back does not
        # land in the window
        os.sync()
        cuda = device.startswith("cuda")
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        got = {}
        setup_s = time.perf_counter() - start
        t0 = time.perf_counter()
        with trace_mod.traced(trace, device, got):
            records = drv.window(seconds)
        window_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        card = torch.cuda.get_device_name() if cuda else "cpu"
        run = drivers.Run(produces=drv.produces, records=records,
                          setup_s=setup_s, trace=got.get("trace"),
                          peak_bw=peaks.hbm_bytes_per_s(card))
        gc.collect()
        numbers, failed = drv.check(records)
        values = {}
        for m in bench.metrics(cell["name"], trace):
            v = metrics.load(m["name"])(run)
            if v is not None:
                values[m["name"]] = {"value": float(v), "unit": m["unit"]}
        dev = {"platform": "gpu" if cuda else "cpu", "kind": card,
               "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
        result = {"correct": check.verdict(numbers, kind.LIMITS),
                  "attempted": len(records), "failed": int(failed),
                  "metrics": values, "device": dev}
        if trace and run.trace is not None:
            dev["busy_s"] = run.trace.busy_s
            dev["window_s"] = run.trace.window_s
            result["breakdown"] = run.trace.breakdown()
        result["power_limit"] = _power_limit() if cuda else None
        result["bytes_written"] = ctx.written
        walls = sorted(r["wall"] for r in records)
        result["window"] = {"seconds": window_s, "records": len(walls),
                            "median_wall_s": walls[len(walls) // 2],
                            "walls_s": [r["wall"] for r in records][:64]}
        result["checks"] = {k: {"value": v, "limit": kind.LIMITS[k]}
                            for k, v in numbers.items()}
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from wtbench import spec

    bench = spec.Bench()
    cell = bench.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"wtbench: the cell needs {cell['chips']} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    result = execute(bench, cell, args.seed, args.seconds, bool(args.trace),
                     "cuda")
    found = forbidden_modules()
    if found:
        print(f"wtbench: the process loaded {found}", file=sys.stderr)
        return 3
    w = result.pop("window")
    print(f"wtbench: {args.workload} seed {args.seed}: wrote "
          f"{result['bytes_written']} bytes under TMPDIR; power limit "
          f"{result['power_limit']}; window {w['seconds']:.3f} s, "
          f"{w['records']} passes, median "
          f"{w['median_wall_s'] * 1e3:.3f} ms, walls {w['walls_s']}",
          file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
