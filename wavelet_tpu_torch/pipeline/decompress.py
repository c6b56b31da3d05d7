"""Decompression pipeline on PyTorch (reference: ``decompress(Config)``,
modes.cpp:115-204).

Counterpart of ``wavelet_tpu.pipeline.decompress`` for the main path:

  1. host: read the sidecars (runinfo/boxcounts/locations/dimensions/
     amrexinfo/meta);
  2. streaming loop, one timestep at a time: parallel read + xz decode +
     RLE scatter into coefficient batches (runtime/engine.HostPacker),
     device inverse Haar per shape bucket, then regenerate that timestep's
     plotfile byte-identically (io/plotfile.write_plotfile) and free.

Partial retrieval (timestep window, component subset, level prefix) is
ported; preview and sparse transfer are not, and an archive written with
``scales>1`` raises ``NotImplementedError``.
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

__all__ = ["decompress_run", "iter_decompressed_timesteps"]


def _unpack_bucket(cfg, eng, packer, dims, bucket_items, arena=None):
    """HOST stage of one shape bucket: read + decode into a filled
    coefficient ShapeBatch (no device work, so a prefetch worker can run
    it behind the previous bucket's inverse)."""
    batch = batching.empty_batch(bucket_items, dims,
                                 pack=eng.pack_factor(dims),
                                 pad_multiple=eng.pad_multiple_for(dims),
                                 layout=eng.coeff_layout(dims),
                                 scales=eng.eff_scales(dims),
                                 arena=arena)
    packer.unpack_into(cfg.compressed_dir, batch)
    return batch


def _decompress_timestep(cfg, eng, packer, comp_idxs, t, num_levels,
                         counts, dimensions, stats, arena=None):
    """Decode + inverse-transform every box of timestep ``t``.

    Returns ``regen``: [lev][box] -> (C, X, Y, Z) float32, and adds the
    host-to-device bytes and the seconds of the host (unpack) and device
    (H2D, inverse kernel, D2H) stages to ``stats``.  ``prefetch=1`` runs
    bucket i+1's host stage behind bucket i's device inverse."""
    buckets = {}
    for li in range(num_levels):
        for b in range(counts[t][li]):
            dims = tuple(dimensions[t][li][b])
            for comp_idx in comp_idxs:
                buckets.setdefault(dims, []).append(
                    batching.WorkItem(t=t, level=li, comp_idx=comp_idx,
                                      box=b))
    comp_pos = {c: k for k, c in enumerate(comp_idxs)}
    ncomp = len(comp_idxs)
    regen = [[None] * counts[t][li] for li in range(num_levels)]
    order = list(buckets.items())

    def host_stage(j):
        dims, bucket_items = order[j]
        t0 = time.perf_counter()
        batch = _unpack_bucket(cfg, eng, packer, dims, bucket_items, arena)
        stats["unpack_seconds"] += time.perf_counter() - t0
        return batch

    def device_stage(j, batch):
        dims, bucket_items = order[j]
        t0 = time.perf_counter()
        out = eng.decompress_shapebatch(batch)
        stats["device_seconds"] += time.perf_counter() - t0
        stats["host_to_device_bytes"] += batch.data.nbytes
        for i, it in enumerate(bucket_items):
            if regen[it.level][it.box] is None:
                regen[it.level][it.box] = np.zeros((ncomp,) + dims,
                                                   dtype=np.float32)
            regen[it.level][it.box][comp_pos[it.comp_idx]] = out.item_view(i)
        # the device stage fetched its result above, so the input buffer
        # can be recycled for a later bucket's unpack (BufferArena contract)
        if arena is not None:
            arena.release(batch.data)

    if cfg.prefetch > 0 and len(order) > 1:
        with cf.ThreadPoolExecutor(1) as pool:
            nxt = pool.submit(host_stage, 0)
            for j in range(len(order)):
                prepared = nxt.result()
                if j + 1 < len(order):
                    nxt = pool.submit(host_stage, j + 1)
                device_stage(j, prepared)
    else:
        for j in range(len(order)):
            device_stage(j, host_stage(j))
    return regen


def iter_decompressed_timesteps(cfg: common.Config, stats=None):
    """Generator over regenerated timesteps: yields
    ``(t, plotfile_name, regen, locations_t, dimensions_t, info, amrex)``
    one timestep at a time, holding only that timestep's boxes.  A
    ``stats`` dict, if given, accumulates ``host_to_device_bytes`` and
    the ``unpack_seconds`` / ``device_seconds`` of the two stages.

    Partial retrieval: ``cfg.min_time``/``cfg.max_time`` select timesteps
    by the same numeric-key rule as compression, ``cfg.components`` a
    subset of the archived components, ``cfg.levels_upto`` an
    archive-level prefix.  Only the selected payloads are read."""
    info = archive.read_runinfo(cfg.compressed_dir)
    full_levels = common.format_levels(info.min_level, info.max_level)
    num_times = len(info.files)
    counts = archive.read_boxcounts(cfg.compressed_dir, num_times,
                                    len(full_levels))
    locations = archive.read_locdim(cfg.compressed_dir, "locations.raw",
                                    counts)
    dimensions = archive.read_locdim(cfg.compressed_dir, "dimensions.raw",
                                     counts)
    amrex = archive.read_amrexinfo(cfg.compressed_dir)
    rr = amrex.ref_ratios
    if len(rr) == 3 and rr[0] > 0 and rr[1] == 0 and rr[2] == 0:
        # a reference-written archive stores {r, 0, 0} (preprocess.cpp:
        # 211-221); the ratio is uniform per dim in every plotfile
        log.info("amrexinfo ref_ratios %s normalized to {%d,%d,%d} "
                 "(reference writer quirk)", rr, rr[0], rr[0], rr[0])
        amrex = archive.AMReXInfo(
            amrex.geomcellinfo, [rr[0]] * 3, amrex.true_times,
            amrex.level_steps, amrex.x_dim, amrex.y_dim, amrex.z_dim)
    meta = archive.read_meta(cfg.compressed_dir)
    if meta.get("scales", 1) != 1:
        raise NotImplementedError(
            f"archive has scales={meta.get('scales')}: multi-scale "
            "decompression is not yet ported")

    # --- selection (defaults = everything, the reference behavior) ------
    levels = full_levels
    if cfg.levels_upto is not None:
        levels = [lv for lv in full_levels if lv <= cfg.levels_upto]
        if not levels:
            raise ValueError(
                f"maxlevel={cfg.levels_upto} selects no archive level "
                f"(archive has levels {full_levels})")
    num_levels = len(levels)   # a PREFIX of the archive's level list
    if stats is not None:
        stats["levels_selected"] = num_levels
    if cfg.components:
        missing = [c for c in cfg.components if c not in info.components]
        if missing:
            raise ValueError(
                f"components not in archive: {missing} "
                f"(archive has {info.components})")
        chosen = set(cfg.components)
        sel = [(n, i) for n, i in zip(info.components, info.comp_idxs)
               if n in chosen]
        comp_names = [n for n, _ in sel]
        comp_idxs = [i for _, i in sel]
    else:
        comp_names, comp_idxs = list(info.components), list(info.comp_idxs)
    if cfg.min_time or cfg.max_time:
        lo = (common.clean_string(cfg.min_time) if cfg.min_time
              else -(1 << 62))
        hi = (common.clean_string(cfg.max_time) if cfg.max_time
              else (1 << 62))
        sel_times = [t for t, f in enumerate(info.files)
                     if lo <= common.clean_string(os.path.basename(f)) <= hi]
        if not sel_times:
            raise ValueError(
                f"minfile={cfg.min_time!r} maxfile={cfg.max_time!r} select "
                f"no archived timestep (archive has {info.files})")
    else:
        sel_times = list(range(num_times))
    sel_info = archive.RunInfo(info.files, info.min_level,
                               levels[-1], comp_names, comp_idxs)
    if (len(sel_times) < num_times or num_levels < len(full_levels)
            or len(comp_names) < len(info.components)):
        log.info("Partial retrieval: %d of %d timesteps, levels %s of %s, "
                 "%d of %d components", len(sel_times), num_times, levels,
                 full_levels, len(comp_names), len(info.components))

    packer = engine.HostPacker(payload=meta.get("payload", "f32"),
                               codec=meta.get("codec", "xz"),
                               archive_format=meta.get("archive", "files"))
    eng = engine.CodecEngine(device=cfg.device)
    arena = batching.BufferArena()   # same shape buckets recur every step
    if stats is None:
        stats = {}
    stats.setdefault("host_to_device_bytes", 0)
    stats.setdefault("unpack_seconds", 0.0)
    stats.setdefault("device_seconds", 0.0)
    for t in sel_times:
        arena.new_generation()
        regen = _decompress_timestep(cfg, eng, packer, comp_idxs, t,
                                     num_levels, counts, dimensions, stats,
                                     arena=arena)
        name = os.path.join(cfg.out_dir, os.path.basename(info.files[t]))
        yield (t, name, regen, locations[t][:num_levels],
               dimensions[t][:num_levels], sel_info, amrex)


def decompress_run(cfg: common.Config) -> dict:
    engine.resolve_device(cfg.device)   # fail before writing any output
    info = archive.read_runinfo(cfg.compressed_dir)
    log.info("Decompressing data between timestep %s and %s, level %s and %s, "
             "for %s components", info.files[0], info.files[-1],
             info.min_level, info.max_level, len(info.components))

    os.makedirs(cfg.out_dir, exist_ok=True)
    n_boxes = 0
    n_times = 0
    num_levels = 0
    stats: dict = {"write_seconds": 0.0}
    with phase_timer(
            "decompress",
            message="Decompression completed in %s seconds.") as ph, \
            cf.ThreadPoolExecutor(1) as write_pool:
        # prefetch=1: timestep t's plotfile write runs on the worker while
        # t+1 decodes; the single worker keeps writes ordered
        pending = None
        for (t, name, regen, locs_t, dims_t, rinfo, amrex) in \
                iter_decompressed_timesteps(cfg, stats=stats):
            num_levels = len(locs_t)   # the SELECTED level prefix
            log.info("%s", name)
            geom = amrex.geomcellinfo[t]
            job = (plotfile.write_plotfile,
                   name,
                   [regen[li] for li in range(num_levels)],
                   [locs_t[li] for li in range(num_levels)],
                   [dims_t[li] for li in range(num_levels)],
                   rinfo.components,
                   float(amrex.true_times[t]),
                   geom[0:3], geom[3:6],
                   amrex.ref_ratios,
                   (amrex.x_dim, amrex.y_dim, amrex.z_dim),
                   # the Header emits one level-steps token per entry
                   amrex.level_steps[t][:num_levels],
                   cfg.out_precision)
            t0 = time.perf_counter()
            if cfg.prefetch > 0:
                if pending is not None:
                    pending.result()
                pending = write_pool.submit(*job)
            else:
                job[0](*job[1:])
            stats["write_seconds"] += time.perf_counter() - t0
            n_boxes += sum(len(per) for per in regen)
            n_times += 1
        if pending is not None:
            t0 = time.perf_counter()
            pending.result()
            stats["write_seconds"] += time.perf_counter() - t0
    log.info("Sucessfully wrote plotfiles.")
    stats.update({"decompress_seconds": ph.seconds, "times": n_times,
                  "levels": stats.pop("levels_selected", num_levels),
                  "boxes": n_boxes})
    return stats
