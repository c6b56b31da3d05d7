"""Quality at scale: RMSE, adjusted loss and size of the port's estimator.

    python -m wavelet_tpu_torch.scripts.bench_quality [--device cuda|cpu]
        [--n-boxes 1024] [--subset-boxes 32] [--root DIR]
        [--recorded PATH] [--out bench_results_torch/quality_at_scale.json]

The counterpart of the JAX package's ``scripts/bench_quality.py``, with
its dataset byte for byte: one timestep, one level of ``--n-boxes``
smooth+shock 64^3 boxes (1024: 1 GiB of f32).  ``-estimate
fastestimate=1`` reports RMSE, adjusted loss and compressed size for keep
in {0.99, 0.999, 0.9999} (box thresholds) and keepfraction in {0.05,
0.02, 0.005} (global thresholds); estimator semantics: modes.cpp:209-328.

The at-scale run goes on ``--device``; then the ``--subset-boxes`` run on
the card and on the CPU, in this process, must report identical metrics
(walls aside), or the program exits 1 (with ``--device cpu`` the subset
runs on the CPU only and nothing is compared).  ``--recorded PATH`` names
the JAX script's artifact (``bench_results/quality_at_scale.json``): each
metric of the at-scale run is reported beside its ``at_scale_cpu_1GiB``
value, equal or not.  That file is a JAX CPU artifact; the comparison
reports and does not gate, and nothing is read without the flag.

Each dataset is written into a directory of its own made under
``--root`` (default: the temporary directory) and removed after its run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from wavelet_tpu_torch.io import plotfile as pf
from wavelet_tpu_torch.pipeline.common import Config
from wavelet_tpu_torch.pipeline.estimate import estimate_run
from wavelet_tpu_torch.scripts import harness

__all__ = ["DIM", "SEED", "KEEPS", "FRACS", "synth_dataset", "run_sweeps",
           "strip_walls", "compare_recorded", "main"]

OUT = os.path.join("bench_results_torch", "quality_at_scale.json")
DIM = 64
SEED = 800
KEEPS = [0.99, 0.999, 0.9999]
FRACS = [0.05, 0.02, 0.005]


def synth_dataset(root: str, n_boxes: int):
    """One-timestep, one-level plotfile of n_boxes 64^3 smooth+shock boxes
    (deterministic: the CPU and TPU children must see identical bytes)."""
    rng = np.random.default_rng(SEED)
    xs = np.linspace(0, 1, DIM, dtype=np.float32)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    boxes, locs, dims = [], [], []
    side = int(np.ceil(n_boxes ** (1 / 3)))
    for b in range(n_boxes):
        cx, cy = rng.random(2)
        smooth = (np.sin(5 * (X - cx)) * np.cos(4 * (Y - cy))
                  + 2.0 * Z + 3.0)
        shock = np.tanh(80 * (X + 0.6 * Y - 1.1 * cx)) * (1 + rng.random())
        boxes.append([(smooth + shock).astype(np.float32)])
        i, j, k = b % side, (b // side) % side, b // (side * side)
        locs.append((i * DIM, j * DIM, k * DIM))
        dims.append((DIM, DIM, DIM))
    d = os.path.join(root, "plt00800")
    pf.write_plotfile(d, [[np.asarray(bx) for bx in boxes]], [locs],
                      [dims], ["f"], 0.8, [0., 0., 0.], [1., 1., 1.],
                      (2, 2, 2), (side * DIM, side * DIM, side * DIM),
                      [800], precision="f32")
    return root


def run_sweeps(data_dir: str, device: str = "cuda"):
    base = dict(data_dir=data_dir, min_time="plt00800",
                max_time="plt00800", min_level=0, max_level=0,
                components=["f"], fast_estimate=True, device=device)
    box = estimate_run(Config(keep_sweep=KEEPS, **base))
    glob = estimate_run(Config(
        threshold_mode="global", keep_fraction_sweep=FRACS, **base))
    return {"box_keep_sweep": box, "global_keepfraction_sweep": glob}


def run_at(root, n_boxes: int, device: str) -> dict:
    """Both sweeps on ``n_boxes`` boxes on ``device``, with the wall of the
    sweeps (the dataset's write excluded)."""
    with harness.private_dir(root, "wtc_quality_") as d:
        synth_dataset(d, n_boxes)
        t0 = time.perf_counter()
        res = run_sweeps(d, device)
        res["wall_s"] = round(time.perf_counter() - t0, 3)
    res["platform"] = device
    res["n_boxes"] = n_boxes
    res["dataset_bytes"] = n_boxes * DIM ** 3 * 4
    return res


def strip_walls(d):
    if isinstance(d, dict):
        return {k: strip_walls(v) for k, v in sorted(d.items())
                if k not in ("wall_s", "platform")}
    return d


def _metrics(run: dict, prefix=()) -> dict:
    """{"sweep/value/.../name": number} of both sweeps of a run."""
    out = {}
    for k, v in run.items():
        if isinstance(v, dict):
            out.update(_metrics(v, prefix + (k,)))
        elif prefix:
            out["/".join(prefix + (k,))] = v
    return out


def compare_recorded(run: dict, path: str) -> dict:
    """Each metric of ``run`` beside the JAX artifact's
    ``at_scale_cpu_1GiB`` value at ``path``."""
    with open(path) as f:
        rec = json.load(f)["at_scale_cpu_1GiB"]
    mine, theirs = _metrics(strip_walls(run)), _metrics(strip_walls(rec))
    rows = {k: {"port": mine.get(k), "recorded": theirs.get(k),
                "equal": mine.get(k) == theirs.get(k)}
            for k in sorted(set(mine) | set(theirs))}
    return {"artifact": path, "n_boxes": run["n_boxes"],
            "recorded_n_boxes": rec.get("n_boxes"),
            "recorded_platform": rec.get("platform"),
            "recorded_wall_s": rec.get("wall_s"),
            "all_equal": all(r["equal"] for r in rows.values()),
            "differing": [k for k, r in rows.items() if not r["equal"]],
            "metrics": rows}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m wavelet_tpu_torch.scripts.bench_quality",
        description="Estimator quality of wavelet_tpu_torch at scale.")
    ap.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    ap.add_argument("--n-boxes", type=int, default=1024,
                    help="boxes of the at-scale run (1024: 1 GiB)")
    ap.add_argument("--subset-boxes", type=int, default=32,
                    help="boxes of the card-against-CPU run")
    ap.add_argument("--root", default=None,
                    help="the directory under which each dataset gets its "
                         "own (default: the temporary directory)")
    ap.add_argument("--recorded", default=None, metavar="PATH",
                    help="the JAX script's quality_at_scale.json to report "
                         "each metric against (default: none)")
    ap.add_argument("--out", default=OUT)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    a = parse_args(argv)
    dev, card = harness.device_card(a.device)
    big = run_at(a.root, a.n_boxes, dev.type)
    print("at scale:", json.dumps({"n_boxes": a.n_boxes,
                                   "wall_s": big["wall_s"]}), flush=True)
    sub = {"cuda": None, "cpu": run_at(a.root, a.subset_boxes, "cpu")}
    agree = None
    if dev.type == "cuda":
        sub["cuda"] = run_at(a.root, a.subset_boxes, "cuda")
        agree = strip_walls(sub["cpu"]) == strip_walls(sub["cuda"])
    out = {"timestamp": time.strftime("%Y-%m-%d %H:%M:%S"), "card": card,
           "device": dev.type, "at_scale": big,
           "subset_cuda_vs_cpu": {"n_boxes": a.subset_boxes,
                                  "all_metrics_identical": agree, **sub},
           "recorded": (compare_recorded(big, a.recorded)
                        if a.recorded else None)}
    harness.write_json(a.out, out, indent=1)
    rec = out["recorded"]
    print(json.dumps({"at_scale_wall_s": big["wall_s"],
                      "subset_identical": agree,
                      "recorded_all_equal": rec and rec["all_equal"]}),
          flush=True)
    return 1 if agree is False else 0


if __name__ == "__main__":
    sys.exit(main())
