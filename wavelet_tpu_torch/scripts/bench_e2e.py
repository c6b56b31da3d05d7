"""End-to-end compress and decompress GB/s of the port on >= 1 GiB datasets.

    python -m wavelet_tpu_torch.scripts.bench_e2e [--device cuda|cpu]
        [--root DIR]
        [--out bench_results_torch/e2e_compress.json]
        [--configs cube64,cube128,global64] [--boxes N] [--timesteps T]
        [--keep-files]

The full pipeline — plotfile read -> device codec -> D2H -> host pack
(``codec=raw archive=bundle keep=0.999``) -> bundle write — on synthetic
~1%-kept datasets of 64^3 (512 boxes) and 128^3 (64 boxes) boxes, two
timesteps each: 1 GiB of f32 boxes per configuration, 2 GiB of f64 FABs
on disk.  Each run writes into a directory of its own, made under
``--root`` (default: the temporary directory; ``--root /dev/shm`` keeps the
datasets in memory) and removed at the end unless ``--keep-files``; the
JSON names it as ``run_dir``.  Nothing that was under ``--root`` before
the run is touched.  The counterpart of the JAX package's
``scripts/bench_e2e.py``, with its datasets (the same seeds, byte for
byte) and its variants:

- ``collected``: :func:`~wavelet_tpu_torch.pipeline.compress.
  compress_collected` on boxes already in memory (``common.collect_run``,
  timed apart as ``read_standalone``), with a ``HostPacker``: the
  reference's compress-time window, read excluded;
- ``streaming``: ``compress_run`` with ``prefetch=1`` (read included,
  overlapped);
- ``decompress_streaming``: ``decompress_run`` of the streaming archive
  with ``prefetch=1`` and f32 FABs.

Each row carries ``e2e_measured_gbps`` (f32 box bytes / wall),
``link_share_of_wall`` and ``e2e_link_normalized_gbps`` (the wall less the
link time of the bytes the run moved, with a band from the link measured
before and after the configuration by ``CodecEngine._measure_link``), and
``reconciliation``: the wall predicted from independently measured stage
rates — the link, the device stage (the forward kernel timed as
:mod:`wavelet_tpu_torch.bench` times it, on this configuration's boxes) and
the host pack (one planned batch of this data packed alone) — against the
measured wall.  ``os.sync()`` runs before every variant, and each row
records how long the f64 dataset took to write: host file I/O varies by
host.  On ``--device cpu`` there is no link, and the link fields are null.

``global64`` (:func:`run_global_config`) times ``compress_run`` on 64^3
boxes in three modes, each on data of its own: box thresholding, then
``thresholdmode=global keepfraction=0.01`` with the default
``globalcache`` (the coefficients of pass 1 kept in host RAM for pass 2),
then the same with ``globalcache=0`` (pass 2 reads and transforms every
timestep again).  ``cached_vs_box_wall_ratio`` says how close the cache
brings a global run to a box run, ``cached_vs_uncached_speedup`` what it
saves.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from wavelet_tpu_torch import bench
from wavelet_tpu_torch.io import plotfile as pf
from wavelet_tpu_torch.kernels import haar_cuda
from wavelet_tpu_torch.pipeline import common
from wavelet_tpu_torch.pipeline import compress as compress_mod
from wavelet_tpu_torch.pipeline.decompress import decompress_run
from wavelet_tpu_torch.runtime import batching, engine
from wavelet_tpu_torch.runtime.mesh import resolve_device
from wavelet_tpu_torch.scripts import harness

__all__ = ["CONFIGS", "GLOBAL_MODES", "smooth_spiky_boxes", "write_dataset",
           "run_config", "run_global_config", "main"]

# label -> (box edge, boxes per timestep, timesteps): 1 GiB of f32 each
CONFIGS = {"cube64": (64, 512, 2), "cube128": (128, 64, 2),
           "global64": (64, 512, 2)}
# global64's modes in the JAX script's order: (name, extra Config keys)
GLOBAL_MODES = (
    ("box", {}),
    ("global_cached", {"threshold_mode": "global", "keep_fraction": 0.01}),
    ("global_uncached", {"threshold_mode": "global", "keep_fraction": 0.01,
                         "global_cache_bytes": 0}))
# the pipeline's own stage seconds and bytes each global64 mode reports
STAGE_KEYS = ("read_seconds", "device_seconds", "pack_wait_seconds",
              "device_to_host_bytes")
OUT = os.path.join("bench_results_torch", "e2e_compress.json")
KEEP = 0.999


def smooth_spiky_boxes(n_boxes: int, dim: int, seed: int):
    """~1%-kept boxes (the sparse regime real AMR fields sit in): smooth
    low-amplitude background + sparse strong positive spikes."""
    rng = np.random.default_rng(seed)
    out = np.empty((n_boxes, dim, dim, dim), np.float32)
    ax = np.arange(dim, dtype=np.float32)
    base = (np.sin(0.11 * ax)[:, None, None]
            + np.cos(0.07 * ax)[None, :, None]
            * np.sin(0.05 * ax)[None, None, :])
    for b in range(n_boxes):
        a = (base * 1e-3
             + rng.standard_normal((dim, dim, dim)).astype(np.float32) * 1e-3)
        mask = rng.random((dim, dim, dim)) < 0.00125
        a[mask] = np.abs(rng.standard_normal(int(mask.sum()))).astype(
            np.float32) * 100
        a.flat[0] = 1000.0
        out[b] = a
    return out


def write_dataset(root: str, name: str, boxes: np.ndarray, dim: int):
    """One level-0 plotfile of one component ``f``, boxes along X."""
    n = boxes.shape[0]
    locs = [(b * dim, 0, 0) for b in range(n)]
    dims = [(dim, dim, dim)] * n
    pf.write_plotfile(os.path.join(root, name), [[bx[None] for bx in boxes]],
                      [locs], [dims], ["f"], 0.25, [0., 0., 0.],
                      [1., 1., 1.], (2, 2, 2), (n * dim, dim, dim), [60])


def _step(t: int) -> str:
    return f"plt{600 + t:05d}"


def _link(dev: torch.device):
    """Link GB/s both ways (pageable copies, as the pipelines make them),
    or None on the CPU."""
    if dev.type != "cuda":
        return None
    with torch.cuda.device(dev):
        return engine.CodecEngine._measure_link()


def _device_stage_gbps(dev: torch.device, dim: int, n_boxes: int) -> float:
    """The forward kernel's rate on this configuration's boxes (at most
    128 MiB per batch), timed as the device-stage bench times it."""
    n = max(1, min(n_boxes, (128 << 20) // (dim ** 3 * 4)))
    nbytes = n * dim ** 3 * 4
    dt, _ = bench.time_stage(
        haar_cuda.fused_forward,
        bench.Inputs(dev, 500 + dim).normal((n, dim, dim, dim)), dev,
        reps=3, iters=5, nbytes=nbytes)
    return nbytes / 1e9 / dt


def _host_pack_gbps(run: common.RunData, dev: torch.device) -> float:
    """The host pack's rate on this data: the first planned batch (at most
    128 MiB) of the run compressed on the device, then packed alone (raw
    codec, bundle) into a scratch directory."""
    eng = engine.CodecEngine(device=dev)
    batch = next(iter(batching.plan_batches(
        compress_mod._iter_workitems(run), max_batch_bytes=128 << 20,
        pack_fn=eng.pack_factor, pad_fn=eng.pad_multiple_for)))
    coeffs, t32 = eng.compress_shapebatch(batch, KEEP)
    packer = engine.HostPacker(payload="f32", codec="raw",
                               archive_format="bundle")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        packer.pack(tmp, coeffs, t32)
        packer.close_bundles()
        dt = time.perf_counter() - t0
    return batch.n_valid * int(np.prod(batch.shape)) * 4 / 1e9 / dt


def _link_fields(v: dict, wall: float, input_bytes: int, h2d: int, d2h: int,
                 links) -> float:
    """Adds the link estimate, its share of the wall and the
    link-normalized rate to row ``v``; -> the link seconds (0 without a
    link)."""
    if None in links:
        v.update(link_seconds_est=None, link_share_of_wall=None,
                 e2e_link_normalized_gbps=None)
        return 0.0
    secs = [h2d / (lk["h2d"] * 1e9) + d2h / (lk["d2h"] * 1e9)
            for lk in links]
    link_s, lo, hi = float(np.mean(secs)), min(secs), max(secs)
    gb = input_bytes / 1e9

    def rate(s):
        return round(gb / (wall - s), 3) if wall > s else None

    v["link_seconds_est"] = {"mean": round(link_s, 4), "lo": round(lo, 4),
                             "hi": round(hi, 4)}
    v["link_share_of_wall"] = round(link_s / wall, 4)
    v["e2e_link_normalized_gbps"] = {
        "point": rate(link_s), "band_lo": rate(lo), "band_hi": rate(hi),
        "caveat": ("ill-conditioned: link is {:.0%} of wall; the band, not "
                   "the point, is the claim".format(link_s / wall)
                   if link_s / wall > 0.8 else "ok")}
    return link_s


def _config_root(root: str, label: str, need: int) -> str:
    """Make ``root/label``, which must not exist, for a run that writes
    up to ``need`` bytes there; refuse before writing when the file
    system has less room."""
    root = os.path.join(root, label)
    os.makedirs(root)
    free = shutil.disk_usage(root).free
    if free < need:
        raise OSError(f"{root}: {free} bytes free, the {label} run needs "
                      f"{need}; pass --root on a larger file system")
    return root


def run_config(label: str, dim: int, n_boxes: int, n_times: int, root: str,
               dev: torch.device, keep_files: bool = False) -> dict:
    """One configuration's row: both compress variants and the decompress
    of the streaming archive, under ``root/label``, which must not exist."""
    input_bytes = n_times * n_boxes * dim ** 3 * 4
    # two f64 datasets, then the f32 plotfiles of the decompress
    root = _config_root(root, label, input_bytes * 5 + (64 << 20))
    t0 = time.perf_counter()
    # distinct data per variant, as the JAX bench writes it
    for t in range(n_times):
        write_dataset(os.path.join(root, "data_c"), _step(t),
                      smooth_spiky_boxes(n_boxes, dim, seed=10 * t + 1), dim)
        write_dataset(os.path.join(root, "data_s"), _step(t),
                      smooth_spiky_boxes(n_boxes, dim, seed=10 * t + 2), dim)
    row = {"dim": dim, "boxes_per_timestep": n_boxes, "timesteps": n_times,
           "input_bytes": input_bytes, "codec": "raw", "archive": "bundle",
           "keep": KEEP, "dataset_write_seconds": round(
               time.perf_counter() - t0, 3)}
    link_before = _link(dev)
    dev_gbps = _device_stage_gbps(dev, dim, n_boxes)

    # --- collected: the reference's compress-time window, read excluded
    os.sync()
    t0 = time.perf_counter()
    run = common.collect_run([os.path.join(root, "data_c", _step(t))
                              for t in range(n_times)], ["f"], [0])
    read_s = time.perf_counter() - t0
    pack_gbps = _host_pack_gbps(run, dev)
    packer = engine.HostPacker(payload="f32", codec="raw",
                               archive_format="bundle")
    arch_c = os.path.join(root, "arch_c") + os.sep
    os.makedirs(arch_c)
    os.sync()
    t0 = time.perf_counter()
    stats = compress_mod.compress_collected(run, KEEP, arch_c, packer=packer,
                                            device=str(dev))
    wall_c = time.perf_counter() - t0
    del run
    shutil.rmtree(os.path.join(root, "data_c"))
    row["read_standalone"] = {"seconds": round(read_s, 3),
                              "gbps": round(input_bytes / 1e9 / read_s, 3)}
    row["collected"] = {"wall_seconds": round(wall_c, 3), **stats}

    # --- streaming: the CLI's path, read included (prefetch=1)
    arch_s = os.path.join(root, "arch_s") + os.sep
    cfg = common.Config(
        data_dir=os.path.join(root, "data_s"), min_time=_step(0),
        max_time=_step(n_times - 1), min_level=0, max_level=0,
        components=["f"], keep=KEEP, compressed_dir=arch_s, codec="raw",
        archive="bundle", prefetch=1, device=str(dev))
    os.sync()
    t0 = time.perf_counter()
    sstats = compress_mod.compress_run(cfg)
    wall_s = time.perf_counter() - t0
    row["streaming"] = {"wall_seconds": round(wall_s, 3), **sstats}

    # --- decompress of the streaming archive, f32 FABs (prefetch=1)
    os.sync()
    t0 = time.perf_counter()
    dstats = decompress_run(common.Config(
        compressed_dir=arch_s, out_dir=os.path.join(root, "regen") + os.sep,
        prefetch=1, out_precision="f32", device=str(dev)))
    dwall = time.perf_counter() - t0
    row["decompress_streaming"] = {"wall_seconds": round(dwall, 3),
                                   "outprec": "f32", **dstats}
    links = (link_before, _link(dev))
    row["link_before"], row["link_after"] = links
    row["stage_rates_gbps"] = {"device_forward": round(dev_gbps, 3),
                               "host_pack": round(pack_gbps, 3),
                               "read": row["read_standalone"]["gbps"]}

    gb = input_bytes / 1e9
    for variant, wall, st in (("collected", wall_c, stats),
                              ("streaming", wall_s, sstats),
                              ("decompress_streaming", dwall, dstats)):
        v = row[variant]
        v["e2e_measured_gbps"] = round(gb / wall, 4)
        if variant == "decompress_streaming":
            # decoded coefficients h2d, reconstructed boxes d2h
            link_s = _link_fields(v, wall, input_bytes,
                                  st["host_to_device_bytes"], input_bytes,
                                  links)
            inrun = max(st["unpack_seconds"] + st["write_seconds"],
                        st["device_seconds"])
            v["reconciliation_inrun"] = {
                "predicted_wall_s": round(inrun, 3),
                "measured_wall_s": round(wall, 3),
                "agreement": round(inrun / wall, 3),
                "model": ("max(unpack + write [prefetch worker], device "
                          "[main loop]) from the run's own stage seconds")}
            continue
        link_s = _link_fields(v, wall, input_bytes, input_bytes,
                              st["device_to_host_bytes"], links)
        stages = {"pack": gb / pack_gbps, "device": gb / dev_gbps}
        if variant == "streaming":
            stages["read"] = read_s
        pred = link_s + max(stages.values())
        v["reconciliation"] = {
            "predicted_wall_s": round(pred, 3),
            "measured_wall_s": round(wall, 3),
            "agreement": round(pred / wall, 3),
            "model": ("link (mean of before/after) + max(" + ", ".join(
                f"{k} {s:.3f} s" for k, s in stages.items()) + ")")}
    if not keep_files:
        shutil.rmtree(root, ignore_errors=True)
    return row


def run_global_config(label: str, dim: int, n_boxes: int, n_times: int,
                      root: str, dev: torch.device,
                      keep_files: bool = False) -> dict:
    """``global64``'s row: the wall of ``compress_run`` in each of
    :data:`GLOBAL_MODES`, on data of its own (seed ``100 * mode + 10 * t +
    3``), under ``root/label``, which must not exist.  Each mode's dataset
    is removed after its run unless ``keep_files``."""
    input_bytes = n_times * n_boxes * dim ** 3 * 4
    # one mode's f64 dataset (all three with keep_files) and three bundles
    # of ~1% kept pairs, 8 bytes each: 2% of the f32 bytes, reserved 6%
    root = _config_root(root, label, (
        input_bytes * 2 * (len(GLOBAL_MODES) if keep_files else 1)
        + len(GLOBAL_MODES) * input_bytes // 16 + (64 << 20)))
    row = {"dim": dim, "boxes_per_timestep": n_boxes, "timesteps": n_times,
           "input_bytes": input_bytes, "codec": "raw", "archive": "bundle"}
    for mi, (name, extra) in enumerate(GLOBAL_MODES):
        data = os.path.join(root, f"data_{name}")
        for t in range(n_times):
            write_dataset(data, _step(t), smooth_spiky_boxes(
                n_boxes, dim, seed=100 * mi + 10 * t + 3), dim)
        cfg = common.Config(
            data_dir=data, min_time=_step(0), max_time=_step(n_times - 1),
            min_level=0, max_level=0, components=["f"], keep=KEEP,
            compressed_dir=os.path.join(root, f"arch_{name}") + os.sep,
            codec="raw", archive="bundle", prefetch=1, device=str(dev),
            **extra)
        os.sync()
        t0 = time.perf_counter()
        stats = compress_mod.compress_run(cfg)
        wall = time.perf_counter() - t0
        row[name] = {"wall_seconds": round(wall, 3),
                     "e2e_measured_gbps": round(input_bytes / 1e9 / wall, 4),
                     "cached_timesteps": stats.get("global_cached_timesteps"),
                     **{k: stats[k] for k in STAGE_KEYS},
                     "global_threshold": stats.get("global_threshold")}
        if not keep_files:
            shutil.rmtree(data)
    walls = {name: row[name]["wall_seconds"] for name, _ in GLOBAL_MODES}
    row["cached_vs_box_wall_ratio"] = round(
        walls["global_cached"] / walls["box"], 3)
    row["cached_vs_uncached_speedup"] = round(
        walls["global_uncached"] / walls["global_cached"], 3)
    if not keep_files:
        shutil.rmtree(root, ignore_errors=True)
    return row


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m wavelet_tpu_torch.scripts.bench_e2e",
        description="End-to-end compress/decompress GB/s of "
                    "wavelet_tpu_torch.")
    ap.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    ap.add_argument("--root", default=None,
                    help="the directory under which this run makes its own "
                         "(default: the temporary directory)")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--configs", default=",".join(CONFIGS),
                    help="comma-separated labels of CONFIGS: cube64, "
                         "cube128, global64 (default: all three)")
    ap.add_argument("--boxes", type=int, default=None,
                    help="boxes per timestep (default: the config's)")
    ap.add_argument("--timesteps", type=int, default=None)
    ap.add_argument("--keep-files", action="store_true",
                    help="leave the run's directory, with its datasets and "
                         "archives")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    a = parse_args(argv)
    dev = resolve_device(a.device)
    results = {
        "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
        "north_star": "BASELINE.json: 10 GB/s/chip end-to-end compress",
        "semantics": ("reference compress-time window = modes.cpp:97-109 "
                      "(data already in memory) -> the 'collected' rows; "
                      "'streaming' rows include plotfile read (prefetch=1)"),
        "platform": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
        "card": bench.card() if dev.type == "cuda" else None,
    }
    run_dir = results["run_dir"] = tempfile.mkdtemp(prefix="wtc_e2e_",
                                                    dir=a.root)
    try:
        for label in a.configs.split(","):
            dim, n_boxes, n_times = CONFIGS[label]
            run = run_global_config if label == "global64" else run_config
            results[label] = run(
                label, dim, a.boxes or n_boxes, a.timesteps or n_times,
                run_dir, dev, a.keep_files)
    finally:
        if not a.keep_files:
            shutil.rmtree(run_dir, ignore_errors=True)
    harness.write_json(a.out, results)
    print(json.dumps(results, default=float), flush=True)
    return results


if __name__ == "__main__":
    main()
