"""Standalone benchmark of the port's host pack/unpack stage.

    python -m wavelet_tpu_torch.scripts.bench_host_codec [--device cuda|cpu]
        [--n-items 64] [--dim 64] [--root DIR] [--tmpfs DIR]
        [--out bench_results_torch/host_codec.json]

The counterpart of the JAX package's ``scripts/bench_host_codec.py`` on
the port's ``io/archive``, ``core/rle`` and ``HostPacker``.  The
end-to-end compress rate is ``min(device_rate, host_pack_rate)`` once the
two stages overlap (the pipeline's pack stream), and the host stage
(threshold + RLE + xz encode + file write, the reference's hot loop #2,
compressor.cpp:260-290) is measured here alone:

- input GB/s of the member codec on one thread at kept fractions of 1%
  and 5% (``--n-items`` items of ``--dim``^3, 64 MiB by default; 16 of
  them a fraction) and xz preset sensitivity, on the tmpfs under
  ``--tmpfs`` (default ``/dev/shm`` where it exists);
- the device stages in the same run, on the same card:
  ``bench.measure`` at [32, 64^3] gives ``pipeline_device_stage_gbps``
  (the forward kernel the pipelines run) and the sparse scatter stage;
- ``archive=bundle`` against per-file members (``HostPacker``) on the
  file system under ``--root``, xz with and without the delta filter
  (``HostPacker`` on every worker) on coefficients from
  ``CodecEngine.compress_batch_raw``, and the pipeline's own overlapped
  device + pack loop (``pipeline.compress._pack_overlapped`` with its
  ``_box_step``) on ``--device``.

With ``--device cpu`` the device fields are null.  Scratch files go in
directories of the run's own, made under ``--root`` and ``--tmpfs`` and
removed at the end.
"""

from __future__ import annotations

import argparse
import json
import lzma
import os
import sys
import tempfile
import time

import numpy as np

from wavelet_tpu_torch import bench
from wavelet_tpu_torch.core import rle
from wavelet_tpu_torch.io import archive
from wavelet_tpu_torch.pipeline import compress as cmod
from wavelet_tpu_torch.runtime import batching, engine as eng_mod
from wavelet_tpu_torch.scripts import harness

__all__ = ["make_coeffs", "bench_python_pack", "bench_preset_sensitivity", "host_rates",
           "device_rates", "bench_xz_delta", "bench_bundle_vs_files",
           "bench_overlapped_pipeline", "main"]

OUT = os.path.join("bench_results_torch", "host_codec.json")


def make_coeffs(n_items: int, m: int, kept_frac: float, seed: int = 0):
    """Wavelet-like coefficients: mostly zeros after thresholding, kept
    values lognormal (heavy-tailed like real detail coefficients)."""
    rng = np.random.default_rng(seed)
    flat = np.zeros((n_items, m), np.float32)
    k = max(1, int(m * kept_frac))
    for i in range(n_items):
        idx = np.sort(rng.choice(m, size=k, replace=False))
        flat[i, idx] = (rng.lognormal(0, 2, k).astype(np.float32)
                        * rng.choice([-1, 1], k).astype(np.float32))
    # threshold 0 keeps exactly the nonzeros
    t32 = np.zeros(n_items, np.float32)
    return flat, t32


def bench_python_pack(flat, t32, dims, out_dir):
    """The member codec (NumPy RLE + xz) on one thread."""
    n, m = flat.shape
    t0 = time.perf_counter()
    total = 0
    for i in range(n):
        mask = np.abs(flat[i]) > t32[i]
        runs, vals = rle.rle_encode_mask(mask, flat[i])
        blob = archive.xz_compress(archive.serialize_payload(dims, runs, vals))
        with open(os.path.join(out_dir, f"py-{i}.xz"), "wb") as f:
            f.write(blob)
        total += len(blob)
    dt = time.perf_counter() - t0
    return flat.nbytes / dt / 1e9, total


def bench_preset_sensitivity(flat, t32, dims):
    """Pure-encode rate and size per xz preset (no file I/O, one payload
    stream): what preset 6 costs vs cheaper settings."""
    payloads = []
    for i in range(len(flat)):
        mask = np.abs(flat[i]) > t32[i]
        runs, vals = rle.rle_encode_mask(mask, flat[i])
        payloads.append(archive.serialize_payload(dims, runs, vals))
    raw_in = flat.nbytes
    rows = {}
    for preset in (0, 1, 3, 6, 9):
        filt = [{"id": lzma.FILTER_LZMA2, "preset": preset}]
        t0 = time.perf_counter()
        sizes = [len(lzma.compress(p, format=lzma.FORMAT_XZ,
                                   check=lzma.CHECK_CRC64, filters=filt))
                 for p in payloads]
        dt = time.perf_counter() - t0
        rows[str(preset)] = {
            "encode_gbps_input": round(raw_in / dt / 1e9, 4),
            "compressed_bytes": int(sum(sizes)),
            "payload_bytes": int(sum(len(p) for p in payloads)),
        }
    return rows


def host_rates(n_items: int, dims, shm: str) -> dict:
    """The member codec's rate at kept fractions of 1% and 5%, and the xz
    presets, on the tmpfs ``shm``."""
    ncpu = os.cpu_count() or 1
    m = int(np.prod(dims))
    results = {"cpu_count": ncpu, "dims": list(dims), "n_items": n_items,
               "item_bytes": m * 4, "python_pack": {},
               "preset_sensitivity": {}}
    for kept in (0.01, 0.05):
        flat, t32 = make_coeffs(n_items, m, kept)
        key = f"kept={kept}"
        with tempfile.TemporaryDirectory(dir=shm) as d:
            pg, _ = bench_python_pack(flat[:16], t32[:16], dims, d)
            results["python_pack"][key] = {"input_gbps_1thread": round(pg, 4)}
        if kept == 0.01:
            results["preset_sensitivity"] = bench_preset_sensitivity(
                flat[:16], t32[:16], dims)
    return results


def device_rates(dev, card) -> dict | None:
    """The device stages of this run's card (None on the CPU):
    ``bench.measure`` at [32, 64^3], 3 reps of 5 launches."""
    if dev.type != "cuda":
        return None
    ex = bench.measure(str(dev), n=32, dim=64, reps=3, iters=5, large_n=1,
                       large_dim=64)["extra"]
    return {"card": card, "source": "wavelet_tpu_torch.bench.measure",
            "block_shape": ex["block_shape"],
            "pipeline_device_stage_gbps": ex["pipeline_device_stage_gbps"],
            "sparse_scatter_stage_gbps": ex["sparse_scatter_stage"][
                "gbps_dense_rebuilt"],
            "launches": ex["launches"]}


def analysis(rates) -> dict:
    """The device rates measured in this run (null on the CPU)."""
    return {"device_compress_gbps": rates and rates[
                "pipeline_device_stage_gbps"],
            "device_scatter_stage_gbps": rates and rates[
                "sparse_scatter_stage_gbps"],
            "device_card": rates and rates["card"]}


def bench_xz_delta(device="cuda", n=8, d=64, root=None):
    """xz6 vs xz6+delta8 size/rate on SMOOTH-field coefficients (where the
    delta filter's win lives: correlated float bit patterns) and on random
    values (its documented worst case)."""
    boxes = np.empty((n, d, d, d), np.float32)
    for b in range(n):
        boxes[b] = np.fromfunction(
            lambda i, j, k: np.sin(0.1 * i + 0.02 * b) * np.cos(0.07 * j)
            + 0.01 * k, (d, d, d)).astype(np.float32)
    eng = eng_mod.CodecEngine(device=device)
    flat, t32 = eng.compress_batch_raw(boxes, 0.9)
    m = flat.shape[1]
    rand_flat, rand_t32 = make_coeffs(n, m, 0.05, seed=9)
    items = [batching.WorkItem(t=0, level=0, comp_idx=0, box=b)
             for b in range(n)]
    out = {}
    for label, (fl, t3) in (("smooth", (flat, t32)),
                            ("random", (rand_flat, rand_t32))):
        batch = batching.ShapeBatch(shape=(d, d, d),
                                    data=fl.reshape(n, d, d, d),
                                    items=items, n_valid=n)
        row = {}
        for dname, delta in (("xz6", 0), ("xz6_delta8", 8)):
            with tempfile.TemporaryDirectory(dir=root) as dd:
                packer = eng_mod.HostPacker(xz_delta=delta)
                t0 = time.perf_counter()
                ob = packer.pack(dd, batch, t3)
                g = fl.nbytes / (time.perf_counter() - t0) / 1e9
                row[dname] = {"input_gbps": round(g, 4),
                              "output_bytes": int(ob)}
        row["delta_size_ratio"] = round(
            row["xz6_delta8"]["output_bytes"] / row["xz6"]["output_bytes"],
            4)
        out[label] = row
    return out


def bench_bundle_vs_files(n_items=2048, dims=(16, 16, 16), root=None):
    """archive=bundle vs per-file layout in the many-small-boxes regime
    (real AMR levels hold thousands of small boxes): same member bytes, one
    container per timestep instead of one file per item.  Measured ON DISK
    deliberately — the per-file open/write/rename cost is what the bundle
    removes."""
    m = int(np.prod(dims))
    flat, t32 = make_coeffs(n_items, m, 0.01, seed=3)
    items = [batching.WorkItem(t=0, level=0, comp_idx=0, box=b)
             for b in range(n_items)]
    batch = batching.ShapeBatch(items=items, shape=dims,
                                data=flat.reshape((n_items,) + dims),
                                n_valid=n_items)
    out = {"items": n_items, "dims": list(dims),
           "input_bytes": int(flat.nbytes)}
    for fmt in ("files", "bundle"):
        best = 0.0
        for _ in range(3):
            with tempfile.TemporaryDirectory(dir=root) as d:
                packer = eng_mod.HostPacker(codec="raw", archive_format=fmt)
                t0 = time.perf_counter()
                members = packer.pack(d, batch, t32)
                container = packer.close_bundles()
                dt = time.perf_counter() - t0
                out[fmt + "_member_bytes"] = int(members)
                if fmt == "bundle":
                    out["bundle_container_bytes"] = int(container)
                best = max(best, flat.nbytes / dt / 1e9)
        out[fmt + "_gbps"] = round(best, 4)
    out["speedup"] = round(out["bundle_gbps"] / out["files_gbps"], 2)
    return out


def bench_overlapped_pipeline(device="cuda", n=48, d=64, root=None):
    """The pipeline's own overlapped device-codec + host-pack loop
    (``pipeline.compress._pack_overlapped`` driving ``_box_step``, the
    dense box-threshold step) end to end on ``device``: puts a measured
    number on 'e2e = min(device, host-pack)'.  Smooth data (realistic
    coefficient decay) so keep=0.999 keeps a few percent."""
    boxes = np.empty((n, d, d, d), np.float32)
    for b in range(n):
        boxes[b] = np.fromfunction(
            lambda i, j, k: np.sin(0.1 * i + 0.03 * b) * np.cos(0.07 * j)
            + 0.01 * k, (d, d, d)).astype(np.float32)
    eng = eng_mod.CodecEngine(device=device)
    # pick the keep whose kept fraction lands nearest the realistic 1-5%
    # regime for this data (the per-box rule's kept fraction is data-
    # dependent; real AMR fields at keep=0.999 keep a few percent)
    keep = 0.999
    kept = 1.0
    for cand in (0.999, 0.99, 0.97, 0.9, 0.8):
        _flat, mask = eng.compress_batch(boxes[:4], cand)
        kf = float(mask.mean())
        keep, kept = cand, kf
        if kf <= 0.05:
            break
    out = {"device": str(eng.device), "keep": keep,
           "kept_fraction": round(kept, 5), "boxes": n, "dims": [d, d, d],
           "input_bytes": int(boxes.nbytes)}
    for codec in ("xz", "raw"):
        packer = eng_mod.HostPacker(codec=codec)
        items = [(batching.WorkItem(t=0, level=0, comp_idx=0, box=b),
                  boxes[b]) for b in range(n)]
        stats = cmod._new_stats()
        with tempfile.TemporaryDirectory(dir=root) as tdir:
            batches = batching.plan_batches(items, pack_fn=eng.pack_factor,
                                            max_batch_bytes=16 << 20)
            t0 = time.perf_counter()
            pending = []
            cmod._pack_overlapped(
                batches, cmod._box_step(eng, packer, keep, "dense", stats),
                tdir, stats, packer, pending)
            cmod._finish(packer, pending, [], stats)
            dt = time.perf_counter() - t0
        ib, ob = stats["input_bytes"], stats["output_bytes"]
        out[f"codec={codec}"] = {
            "e2e_input_gbps": round(ib / dt / 1e9, 4),
            "output_ratio_pct": round(100.0 * ob / ib, 3),
            "device_seconds": round(stats["device_seconds"], 4),
            "pack_wait_seconds": round(stats["pack_wait_seconds"], 4)}
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m wavelet_tpu_torch.scripts.bench_host_codec",
        description="Host pack rates of wavelet_tpu_torch beside "
                    "the device rates of the same card.")
    ap.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    ap.add_argument("--n-items", type=int, default=64,
                    help="items per pack loop (the overlapped loop takes "
                         "3/4 of them as boxes, the delta filter 1/8, the "
                         "bundle test 32x as many 16^3 items)")
    ap.add_argument("--dim", type=int, default=64, help="box edge")
    ap.add_argument("--root", default=None,
                    help="the file system of the on-disk measurements "
                         "(default: the temporary directory)")
    ap.add_argument("--tmpfs", default=None,
                    help="the tmpfs of the codec-rate loops (default: "
                         "/dev/shm where it exists, else --root)")
    ap.add_argument("--out", default=OUT)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    a = parse_args(argv)
    dev, card = harness.device_card(a.device)
    tmpfs = a.tmpfs or ("/dev/shm" if os.path.isdir("/dev/shm") else a.root)
    dims = (a.dim,) * 3
    with harness.private_dir(a.root, "wtc_host_codec_") as disk, \
            harness.private_dir(tmpfs, "wtc_host_codec_") as shm:
        results = host_rates(a.n_items, dims, shm)
        results["card"] = card
        results["device"] = dev.type
        results["analysis"] = analysis(device_rates(dev, card))
        results["bundle_vs_files"] = bench_bundle_vs_files(
            a.n_items * 32, root=disk)
        results["pipeline_e2e"] = bench_overlapped_pipeline(
            str(dev), max(1, a.n_items * 3 // 4), a.dim, root=disk)
        results["xz_delta"] = bench_xz_delta(
            str(dev), max(1, a.n_items // 8), a.dim, root=shm)
    harness.write_json(a.out, results, indent=1)
    print(json.dumps(results["analysis"]))
    print(json.dumps(results["pipeline_e2e"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
