"""BASELINE.json configs 3-6 on the port.

    python -m wavelet_tpu_torch.scripts.measure_baseline [--device cuda|cpu]
        [--only 3,4,5,6] [--scale 1.0] [--work DIR]
        [--out bench_results_torch/measured.json]

The counterpart of the JAX package's ``scripts/measure_baseline.py`` for
its configs 3-6, with its datasets (byte for byte: the same generators,
seeds and per-mode perturbations), ``Config``s, mode lists and stats:

3. keep sweep {0.99, 0.999, 0.9999} on a synthetic plotfile (estimate);
4. a large synthetic AMR set (1000 boxes of 16^3, 2 components): box,
   box with ``transfer=sparse`` and global (keepfraction 0.02) compress;
5. 64 smooth boxes of 64^3, compress + decompress end to end: xz files,
   raw files, raw bundle, raw sparse bundle, each on its own slightly
   offset dataset;
6. 64 spiky (~1%-kept) boxes of 64^3, dense against sparse transfer on
   the raw/bundle path, both directions.

Configs 1 and 2 read the C++ reference's golden plotfiles, which are not
in the repository.  ``--scale F`` multiplies every config's box count
(``--scale 0.25`` runs config 6 on 16 boxes).  Each config writes its
data, archives and plotfiles under ``--work`` (default: a temporary
directory removed at the end).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from wavelet_tpu_torch import bench
from wavelet_tpu_torch.io import plotfile as pf
from wavelet_tpu_torch.pipeline.common import Config
from wavelet_tpu_torch.pipeline.compress import compress_run
from wavelet_tpu_torch.pipeline.decompress import decompress_run
from wavelet_tpu_torch.pipeline.estimate import estimate_run
from wavelet_tpu_torch.runtime import engine as eng_mod
from wavelet_tpu_torch.runtime.mesh import resolve_device
from wavelet_tpu_torch.scripts import harness

__all__ = ["synthetic_plotfile", "spiky_plotfile", "CONFIG4_MODES",
           "CONFIG5_MODES", "config3", "config4", "config5", "config6",
           "main"]

OUT = os.path.join("bench_results_torch", "measured.json")
CONFIG4_MODES = (("box", {"keep": 0.999}),
                 ("box_sparse", {"keep": 0.999, "transfer": "sparse"}),
                 ("global", {"keep_fraction": 0.02}))
CONFIG5_MODES = (("parity_xz_files", {}),
                 ("raw_files", {"codec": "raw"}),
                 ("raw_bundle", {"codec": "raw", "archive": "bundle"}),
                 ("raw_sparse_bundle", {"codec": "raw", "archive": "bundle",
                                        "transfer": "sparse"}))


def synthetic_plotfile(tmp, n_boxes=27, dim=16, ncomp=2, name="plt00020",
                       offset=0.0):
    """``offset`` shifts the field positive (like physical density/temp
    fields): the reference's signed absmax rule keeps everything on boxes
    whose largest-|.| coefficient is negative, which zero-mean fields hit
    on about half their boxes."""
    rng = np.random.default_rng(0)
    boxes, locs, dims = [], [], []
    side = round(n_boxes ** (1 / 3)) or 1
    count = 0
    for i in range(side):
        for j in range(side):
            for k in range(side):
                x, y, z = np.meshgrid(
                    np.linspace(i, i + 1, dim), np.linspace(j, j + 1, dim),
                    np.linspace(k, k + 1, dim), indexing="ij")
                smooth = (np.sin(2 * x) * np.cos(3 * y) * np.exp(-z / 4)
                          + offset)
                noisy = smooth * 50 + rng.standard_normal(smooth.shape)
                comps = [smooth.astype(np.float32),
                         noisy.astype(np.float32)][:ncomp]
                boxes.append(np.stack(comps))
                locs.append((i * dim, j * dim, k * dim))
                dims.append((dim, dim, dim))
                count += 1
    src = os.path.join(tmp, "synth", name)
    pf.write_plotfile(src, [boxes], [locs], [dims],
                      ["smooth", "noisy"][:ncomp], 0.25, [0., 0., 0.],
                      [1., 1., 1.], (2, 2, 2),
                      (side * dim, side * dim, side * dim), [20])
    return os.path.join(tmp, "synth"), count


def spiky_plotfile(tmp, n_boxes=64, dim=64, name="plt00060", seed=7):
    """Shock/flame-like field: a smooth low-amplitude background with
    sparse high-magnitude point spikes (each spreads into ~8 one-scale
    Haar coefficients, so 0.125% spikes keep ~1% of the coefficients), and
    one strongly positive spike per box so the signed-absmax rule never
    degenerates."""
    rng = np.random.default_rng(seed)
    boxes, locs, dims = [], [], []
    for b in range(n_boxes):
        a = rng.standard_normal((dim, dim, dim)).astype(np.float32) * 1e-3
        mask = rng.random((dim, dim, dim)) < 0.00125
        a[mask] = np.abs(rng.standard_normal(mask.sum())
                         ).astype(np.float32) * 100
        a.flat[0] = 1000.0
        boxes.append(a[None])
        locs.append((b * dim, 0, 0))
        dims.append((dim, dim, dim))
    src = os.path.join(tmp, "spiky", name)
    pf.write_plotfile(src, [boxes], [locs], [dims], ["f"], 0.25,
                      [0., 0., 0.], [1., 1., 1.], (2, 2, 2),
                      (n_boxes * dim, dim, dim), [60])
    return os.path.join(tmp, "spiky"), n_boxes


def _boxes(n: int, scale: float) -> int:
    return max(1, round(n * scale))


def _e2e(stats: dict, n_boxes: int, d: dict | None = None) -> dict:
    """The JAX script's per-mode stats: boxes, compress GB/s and, after a
    decompress ``d``, its seconds, H2D bytes and GB/s."""
    stats["boxes"] = n_boxes
    stats["compress_gbps_e2e"] = (stats["input_bytes"] / 1e9
                                  / stats["compress_seconds"])
    if d is not None:
        stats["decompress_seconds"] = d["decompress_seconds"]
        stats["host_to_device_bytes"] = d.get("host_to_device_bytes")
        stats["decompress_gbps_e2e"] = (stats["input_bytes"] / 1e9
                                        / d["decompress_seconds"])
    return stats


def config3(results, tmp, scale=1.0, device="cuda"):
    data_dir, _ = synthetic_plotfile(tmp, n_boxes=_boxes(27, scale))
    sweep = {}
    for keep in (0.99, 0.999, 0.9999):
        cfg = Config(data_dir=data_dir, min_time="plt00020",
                     max_time="plt00020", min_level=0, max_level=0,
                     components=["smooth", "noisy"], keep=keep,
                     device=device)
        sweep[str(keep)] = estimate_run(cfg)
    results["config3_keep_sweep_synthetic"] = sweep


def config4_config(data_dir, tmp, mode, extra, device="cuda") -> Config:
    """Config 4's ``Config`` of one mode (the archive under ``tmp``)."""
    return Config(data_dir=data_dir, min_time="plt00030",
                  max_time="plt00030", min_level=0, max_level=0,
                  components=["smooth", "noisy"],
                  compressed_dir=os.path.join(tmp, f"comp4_{mode}") + os.sep,
                  threshold_mode=mode.split("_")[0], device=device, **extra)


def config4(results, tmp, scale=1.0, device="cuda"):
    data_dir, n_boxes = synthetic_plotfile(tmp, n_boxes=_boxes(1000, scale),
                                           dim=16, name="plt00030")
    out = {}
    for mode, extra in CONFIG4_MODES:
        t0 = time.perf_counter()
        stats = compress_run(config4_config(data_dir, tmp, mode, extra,
                                            device))
        stats["wall_seconds"] = time.perf_counter() - t0
        out[mode] = _e2e(stats, n_boxes)
    results["config4_large_synthetic"] = out


def config5(results, tmp, scale=1.0, device="cuda"):
    """Realistic-regime end-to-end rows: 64 boxes of 64^3 smooth data
    (the keep probed so 1-5% is kept), compress + decompress, the parity
    configuration against the fast-path extensions."""
    n = _boxes(64, scale)
    data_dir, n_boxes = synthetic_plotfile(tmp, n_boxes=n, dim=64, ncomp=1,
                                           name="plt00050", offset=3.0)
    probe = pf.read_level(os.path.join(data_dir, "plt00050"), 0, [0])
    probe_boxes = np.stack(probe.boxes[:4])[:, 0]
    eng = eng_mod.CodecEngine(device=device)
    keep, kept = 0.999, 1.0
    for cand in (0.999, 0.99, 0.97, 0.9, 0.8, 0.5, 0.2):
        _flat, mask = eng.compress_batch(probe_boxes.copy(), cand)
        keep, kept = cand, float(mask.mean())
        if kept <= 0.05:
            break
    out = {"keep": keep, "kept_fraction": round(kept, 5)}
    for mode_i, (mode, extra) in enumerate(CONFIG5_MODES):
        # each mode its own (imperceptibly perturbed) dataset, as the JAX
        # script writes them
        data_dir, _ = synthetic_plotfile(
            os.path.join(tmp, "c5data", mode), n_boxes=n, dim=64, ncomp=1,
            name="plt00050", offset=3.0 + 1e-3 * mode_i)
        # flush the previous mode's dirty pages: no mode is timed against
        # its predecessor's write-back
        os.sync()
        comp = os.path.join(tmp, f"comp5_{mode}") + os.sep
        stats = compress_run(Config(
            data_dir=data_dir, min_time="plt00050", max_time="plt00050",
            min_level=0, max_level=0, components=["smooth"],
            compressed_dir=comp, keep=keep, device=device, **extra))
        os.sync()
        # the sparse row decompresses with transfer=sparse too
        d = decompress_run(Config(
            compressed_dir=comp, out_dir=os.path.join(tmp, f"out5_{mode}")
            + os.sep, transfer=extra.get("transfer", "dense"),
            device=device))
        out[mode] = _e2e(stats, n_boxes, d)
    results["config5_e2e_realistic"] = out


def config6(results, tmp, scale=1.0, device="cuda"):
    """Sparse-regime end-to-end rows: config 5's shape on spiky ~1%-kept
    data, dense against sparse transfer both ways on raw/bundle."""
    out = {}
    for mode_i, transfer in enumerate(("dense", "sparse")):
        name = f"plt0006{mode_i}"
        data_dir, n_boxes = spiky_plotfile(
            os.path.join(tmp, "c6data", transfer), n_boxes=_boxes(64, scale),
            dim=64, name=name, seed=7 + mode_i)
        os.sync()
        comp = os.path.join(tmp, f"comp6_{transfer}") + os.sep
        stats = compress_run(Config(
            data_dir=data_dir, min_time=name, max_time=name, min_level=0,
            max_level=0, components=["f"], compressed_dir=comp, keep=0.999,
            codec="raw", archive="bundle", transfer=transfer,
            device=device))
        os.sync()
        d = decompress_run(Config(
            compressed_dir=comp, out_dir=os.path.join(tmp, f"out6_{transfer}")
            + os.sep, transfer=transfer, device=device))
        out[transfer] = _e2e(stats, n_boxes, d)
    results["config6_e2e_sparse_regime"] = out


CONFIGS = {3: config3, 4: config4, 5: config5, 6: config6}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m wavelet_tpu_torch.scripts.measure_baseline",
        description="BASELINE.json configs 3-6 on wavelet_tpu_torch.")
    ap.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    ap.add_argument("--only", default=None,
                    help="comma-separated config numbers (of 3,4,5,6)")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="multiplies every config's box count")
    ap.add_argument("--work", default=None,
                    help="keep data and archives here (default: a "
                         "temporary directory)")
    ap.add_argument("--out", default=OUT)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    a = parse_args(argv)
    dev = resolve_device(a.device)
    only = (sorted(int(x) for x in a.only.split(",")) if a.only
            else sorted(CONFIGS))
    unknown = set(only) - set(CONFIGS)
    if unknown:
        raise ValueError(f"--only {sorted(unknown)}: configs 1 and 2 need "
                         "the reference's golden plotfiles; this program "
                         "runs 3, 4, 5 and 6")
    results = {"timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
               "platform": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
               "scale": a.scale}
    if dev.type == "cuda":
        results["card"] = bench.card()
    with tempfile.TemporaryDirectory() as tmp:
        work = a.work or tmp
        for k in only:
            CONFIGS[k](results, os.path.join(work, f"config{k}"), a.scale,
                       str(dev))
    harness.write_json(a.out, results)
    print(json.dumps(results, default=float), flush=True)
    return results


if __name__ == "__main__":
    main()
