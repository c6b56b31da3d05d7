"""Compression pipeline on PyTorch (reference: ``compress(Config)``,
modes.cpp:24-112).

Counterpart of ``wavelet_tpu.pipeline.compress`` for the main path:

  1. host: discover files, parse headers + Cell_H box lists, write the
     five sidecar files first (the archive is then resumable state);
  2. streaming loop, one timestep at a time: read FAB boxes
     (io/plotfile), shape-bucketed batches through the device codec
     (fused Haar + max/min -> exact per-box thresholds, runtime/engine),
     host RLE + serialize + xz in the packer, then free.  The device works
     on batch i+1 while one pack thread runs batch i.

Box thresholds, scales=1 and dense transfer only: the JAX package's other
modes are not ported (the CLI raises ``NotImplementedError`` for them).
"""

from __future__ import annotations

import concurrent.futures as cf
import logging
import os
import time

import numpy as np

from wavelet_tpu.io import archive, plotfile
from wavelet_tpu.runtime import batching
from wavelet_tpu.runtime.debug import phase_timer
from wavelet_tpu_torch.pipeline import common
from wavelet_tpu_torch.runtime import engine

log = logging.getLogger("wavelet_tpu_torch")

__all__ = ["compress_run", "write_sidecars_meta"]


def write_sidecars_meta(meta: common.RunMeta, min_level, max_level,
                        out_dir: str):
    """The five metadata files of modes.cpp:71-89, byte-compatible, written
    from the metadata-only pass.  Component names in Header order."""
    info = archive.RunInfo(meta.files, min_level, max_level,
                           list(meta.components), meta.comp_idxs)
    existing = os.path.join(out_dir, "runinfo.raw")
    if os.path.exists(existing):
        # re-running the SAME selection (resume) rewrites identical
        # sidecars; a DIFFERENT run into a populated archive would leave
        # stale payloads behind new sidecars — refuse it
        try:
            old = archive.read_runinfo(out_dir)
        except (ValueError, OSError):
            old = None   # a corrupt runinfo is overwritten, not protected
        if old is not None and old != info:
            raise ValueError(
                f"{out_dir} already contains a different run's archive "
                f"(files {old.files[:2]}..., levels {old.min_level}-"
                f"{old.max_level}, components {old.components}); "
                "compress into an empty directory, or rerun the same "
                "selection (resume=1 skips finished items)")
    archive.write_runinfo(info, out_dir)
    archive.write_locdim(meta.locations, out_dir, "locations.raw")
    archive.write_locdim(meta.dimensions, out_dir, "dimensions.raw")
    archive.write_boxcounts(meta.counts, out_dir)
    archive.write_amrexinfo(meta.amrexinfo, out_dir)
    # meta LAST so its sidecar_crc32 block covers all five .raw files
    archive.write_meta(out_dir)


def _exists(out_dir: str, item, have=None) -> bool:
    """Is this item's output already in the archive?  ``have`` is the
    preloaded member-key set in bundle mode; None = per-file checks."""
    if have is not None:
        return (item.t, item.level, item.comp_idx, item.box) in have
    return os.path.exists(os.path.join(
        out_dir, archive.payload_filename(item.t, item.level,
                                          item.comp_idx, item.box)))


def _have_index(out_dir: str, archive_format: str):
    """Resume index: the (t, lev, comp, box) keys already present (bundle
    mode), or None (files mode stats per file)."""
    if archive_format != "bundle":
        return None
    from wavelet_tpu.io import bundle as bundle_mod

    return set(bundle_mod.BundleSet(out_dir).keys())


def _pack_dense(batches, eng, packer, out_dir: str, keep: float,
                stats: dict) -> None:
    """The overlapped device-codec + host-pack loop: the device transforms
    batch i+1 while a pack thread runs the host RLE+xz+write of batch i.
    One pack worker keeps bundle member order deterministic.  Adds to
    ``stats``: files, bytes, and the seconds spent in the device step
    (H2D, kernel, D2H, thresholds) and waiting on the pack thread."""
    with cf.ThreadPoolExecutor(1) as pack_pool:
        pending = None
        for batch in batches:
            t0 = time.perf_counter()
            coeffs, t32 = eng.compress_shapebatch(batch, keep)
            t1 = time.perf_counter()
            if pending is not None:
                stats["output_bytes"] += pending.result()
            stats["device_seconds"] += t1 - t0
            stats["pack_wait_seconds"] += time.perf_counter() - t1
            pending = pack_pool.submit(packer.pack, out_dir, coeffs, t32)
            stats["device_to_host_bytes"] += coeffs.data.nbytes
            stats["files"] += len(batch.items)
            stats["input_bytes"] += (len(batch.items) *
                                     int(np.prod(batch.shape)) * 4)
        if pending is not None:
            t1 = time.perf_counter()
            stats["output_bytes"] += pending.result()
            stats["pack_wait_seconds"] += time.perf_counter() - t1


def _iter_timestep_items(meta: common.RunMeta, t: int, lv_boxes):
    """This timestep's (WorkItem, array) pairs in (t, lev, box, comp) order."""
    for li in range(len(meta.levels)):
        for b in range(meta.counts[t][li]):
            arr = lv_boxes[li].boxes[b]
            for c, comp_idx in enumerate(meta.comp_idxs):
                yield (batching.WorkItem(t=t, level=li, comp_idx=comp_idx,
                                         box=b), arr[c])


def _iter_prefetched(n_times: int, read_one, depth: int):
    """Yield ``(t, read_one(t))`` for every timestep; with ``depth > 0``
    (``prefetch=1``) timestep t+1 is read in a background thread while the
    caller processes t (two timesteps in memory instead of one)."""
    if depth <= 0:
        for t in range(n_times):
            yield t, read_one(t)
        return
    with cf.ThreadPoolExecutor(1) as pool:
        nxt = pool.submit(read_one, 0) if n_times else None
        for t in range(n_times):
            cur = nxt.result()
            nxt = (pool.submit(read_one, t + 1)
                   if t + 1 < n_times else None)
            yield t, cur


def _compress_streaming(cfg: common.Config, meta: common.RunMeta) -> dict:
    """One-timestep-at-a-time compression: read -> device codec -> host
    pack -> free.  Peak host memory is bounded by one timestep (two with
    ``prefetch=1``)."""
    eng = engine.CodecEngine(device=cfg.device)
    packer = engine.HostPacker(payload=cfg.payload, codec=cfg.codec,
                               xz_preset=cfg.xz_preset,
                               xz_delta=cfg.xz_delta,
                               archive_format=cfg.archive)
    have = (_have_index(cfg.compressed_dir, cfg.archive)
            if cfg.resume else None)

    stats = dict.fromkeys(("files", "input_bytes", "output_bytes",
                           "skipped", "device_to_host_bytes"), 0)
    stats.update(dict.fromkeys(("read_seconds", "device_seconds",
                                "pack_wait_seconds"), 0.0))

    def timestep_batches(t):
        """Read timestep t and plan its batches (data freed with them)."""
        t0 = time.perf_counter()
        lv_boxes = [plotfile.read_level(meta.files[t], lev, meta.comp_idxs)
                    for lev in meta.levels]
        items = list(_iter_timestep_items(meta, t, lv_boxes))
        if cfg.resume:
            kept = [p for p in items
                    if not _exists(cfg.compressed_dir, p[0], have)]
            stats["skipped"] += len(items) - len(kept)
            items = kept
        batches = batching.plan_batches(items, pack_fn=eng.pack_factor,
                                        pad_fn=eng.pad_multiple_for)
        stats["read_seconds"] += time.perf_counter() - t0
        return batches

    bundle_bytes = 0
    for t, batches in _iter_prefetched(len(meta.files), timestep_batches,
                                       cfg.prefetch):
        _pack_dense(batches, eng, packer, cfg.compressed_dir, cfg.keep,
                    stats)
        # a finished timestep's bundle is closed right away: a crash costs
        # one timestep, like the per-file mode
        bundle_bytes += packer.close_bundles(t)
    if stats["skipped"]:
        log.info("Resume: skipped %d already-compressed items",
                 stats["skipped"])
    bundle_bytes += packer.close_bundles()
    if packer.archive_format == "bundle":
        stats["output_bytes"] = bundle_bytes
    return stats


def compress_run(cfg: common.Config) -> dict:
    """Full compression mode (modes.cpp:24-112), streaming per timestep."""
    engine.resolve_device(cfg.device)   # fail before touching the archive
    files = common.format_files(cfg.data_dir, cfg.min_time, cfg.max_time)
    levels = common.format_levels(cfg.min_level, cfg.max_level)
    log.info("This run involves the following files:")
    for f in files:
        log.info("%s", f)

    log.info("Processing data...")
    with phase_timer(
            "preprocess",
            message=("Successfully processed data in %s seconds. "
                     "Beginning compression...")) as pre:
        meta = common.collect_run_meta(files, cfg.components, levels)
        os.makedirs(cfg.compressed_dir, exist_ok=True)
        write_sidecars_meta(meta, cfg.min_level, cfg.max_level,
                            cfg.compressed_dir)
        archive.write_meta(cfg.compressed_dir, keep=cfg.keep,
                           payload=cfg.payload,
                           codec=cfg.codec, xz_preset=cfg.xz_preset,
                           xz_delta=cfg.xz_delta,
                           archive_format=cfg.archive)

    with phase_timer(
            "compress", message="Compression completed in %s seconds.") as ph:
        stats = _compress_streaming(cfg, meta)
        ph.nbytes = stats["input_bytes"]
    stats["preprocess_seconds"] = pre.seconds
    stats["compress_seconds"] = ph.seconds
    return stats
