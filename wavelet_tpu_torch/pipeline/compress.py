"""Compression pipeline on PyTorch (reference: ``compress(Config)``,
modes.cpp:24-112).

Counterpart of ``wavelet_tpu.pipeline.compress``:

  1. host: discover files, parse headers + Cell_H box lists, write the
     five sidecar files first (the archive is then resumable state);
  2. streaming loop, one timestep at a time: read FAB boxes
     (io/plotfile), shape-bucketed batches through the device codec
     (Haar transform or ``scales``-deep pyramid + max/min -> exact per-box
     thresholds, runtime/engine), host RLE + serialize + xz in the packer,
     then free.  The device works on batch i+1 while one pack thread runs
     batch i.  ``transfer=sparse`` (or ``auto`` on a slow link) compacts
     each batch's kept coefficients on the device and fetches only the
     (index, value) pairs; the archive bytes are the same.

``thresholdmode=global`` streams twice: pass 1 sums the coefficient
magnitude histogram of every item (keeping whole timesteps' coefficients
in host RAM up to the ``globalcache`` budget), one threshold keeps
``keep_fraction`` of all coefficients, and pass 2 packs at that threshold,
re-reading the timesteps pass 1 did not keep; pass 2 fetches dense
coefficients, as in the JAX package.

``mesh=`` (``runtime/mesh.data_mesh``, CLI ``devices=N``) splits every
batch over the mesh's entries, and giant boxes along X.  In a
multi-process run (``runtime/mesh.init_distributed``, CLI
``coordinator=``) each process owns a contiguous ``process_local_slice``
of the global work-item sequence, reads only the timesteps that hold its
items and writes its own payloads (bundles carry its process index);
every process writes the same sidecars (atomic renames, last writer
wins).  Global mode sums the processes' histograms before the threshold.

With ``giantmesh=global`` in a multi-process run, giant boxes split over
every process's entries (``CodecEngine(giant_mesh_mode="global")``), so
giant items are collective: every process reads each timestep that holds
a giant box and transforms every giant item of it, in the same order,
while only the item's owner (its slice) writes the payload and counts it
in the stats and the histogram.  Giant items are exempt from the resume
filter (a resumed run recomputes them and rewrites the same bytes), and
the ``globalcache`` admits a timestep by its size over all processes,
which every process computes alike, so every process launches the same
collectives.

:func:`compress_collected` runs the same device codec and host pack over a
run already in memory (``common.collect_run``); the estimate mode
compresses into its scratch directory with it.
"""

from __future__ import annotations

import concurrent.futures as cf
import functools
import logging
import os

import numpy as np

from wavelet_tpu_torch.io import archive, plotfile
from wavelet_tpu_torch.runtime import batching
from wavelet_tpu_torch.runtime.debug import phase_timer, span
from wavelet_tpu_torch.core import threshold
from wavelet_tpu_torch.pipeline import common
from wavelet_tpu_torch.runtime import engine
from wavelet_tpu_torch.runtime import mesh as mesh_lib

log = logging.getLogger("wavelet_tpu_torch")

__all__ = ["compress_run", "compress_collected", "write_sidecars",
           "write_sidecars_meta"]


def _iter_workitems(run: common.RunData):
    """Flatten the (t, lev, comp, box) space of an in-memory run into codec
    work items."""
    for t, per_lev in enumerate(run.levels_data):
        for li, lv in enumerate(per_lev):
            for b, arr in enumerate(lv.boxes):
                for c, comp_idx in enumerate(run.comp_idxs):
                    yield (batching.WorkItem(t=t, level=li, comp_idx=comp_idx,
                                             box=b), arr[c])


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


def write_sidecars(run: common.RunData, min_level, max_level, out_dir: str):
    """Sidecars from an in-memory RunData (compress_collected callers)."""
    meta = common.RunMeta(
        locations=[[lv.locations for lv in per] for per in run.levels_data],
        dimensions=[[lv.dimensions for lv in per] for per in run.levels_data],
        counts=[[len(lv.boxes) for lv in per] for per in run.levels_data],
        comp_idxs=run.comp_idxs, components=list(run.components),
        amrexinfo=run.amrexinfo, files=run.files, levels=run.levels)
    write_sidecars_meta(meta, min_level, max_level, out_dir)


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
    from wavelet_tpu_torch.io import bundle as bundle_mod

    return set(bundle_mod.BundleSet(out_dir).keys())


def _pack_overlapped(batches, device_step, out_dir: str,
                     stats: dict) -> None:
    """The overlapped device-codec + host-pack loop: the device step of
    batch i+1 runs while a pack thread runs the host RLE+xz+write of batch
    i.  ``device_step(batch) -> (pack, n_packed)``: ``pack(out_dir)``
    packs the ``n_packed`` items the step chose and returns the bytes it
    wrote.  One pack worker keeps bundle member order deterministic.  Adds
    to ``stats``: files, bytes, and the seconds spent in the device step
    (H2D, kernels, D2H, thresholds; span ``compress.device_step``, with its
    thread CPU as ``device_cpu_seconds``) and waiting on the pack thread
    (``compress.pack_wait``)."""
    with cf.ThreadPoolExecutor(1) as pack_pool:
        pending = None
        for batch in batches:
            with span("compress.device_step", stats, "device_seconds",
                      cpu=True, args=(*batch.shape, len(batch.items))):
                pack, n_packed = device_step(batch)
            with span("compress.pack_wait", stats, "pack_wait_seconds"):
                if pending is not None:
                    stats["output_bytes"] += pending.result()
            pending = pack_pool.submit(pack, out_dir)
            stats["files"] += n_packed
            stats["input_bytes"] += n_packed * int(np.prod(batch.shape)) * 4
        if pending is not None:
            with span("compress.pack_wait", stats, "pack_wait_seconds"):
                stats["output_bytes"] += pending.result()


def _owned_subset(items, owned):
    """Indices of the ``items`` this process writes (all of them: None),
    given the set of WorkItems it ``owned`` (None: every item)."""
    if owned is None:
        return None
    mine = [i for i, it in enumerate(items) if it in owned]
    return None if len(mine) == len(items) else mine


def _box_step(eng, packer, keep: float, transfer: str, stats: dict,
              owned=None):
    """The box-threshold device step for :func:`_pack_overlapped`: dense,
    or sparse where ``eng.transfer_mode`` says so (only the kept (index,
    value) pairs then cross the device->host link).  Adds the link bytes
    to ``stats``.  ``owned``: the WorkItems this process writes, when a
    batch may hold others' (giant items split across processes, always
    dense)."""
    def step(batch):
        if eng.transfer_mode(batch.shape, transfer) == "sparse":
            sparse, t32 = eng.compress_shapebatch_sparse(batch, keep)
            stats["device_to_host_bytes"] += sparse.transfer_bytes()
            return (functools.partial(packer.pack_sparse, sparse=sparse,
                                      t32=t32), len(batch.items))
        coeffs, t32 = eng.compress_shapebatch(batch, keep)
        stats["device_to_host_bytes"] += coeffs.data.nbytes
        subset = _owned_subset(batch.items, owned)
        return (functools.partial(packer.pack, coeff_batch=coeffs, t32=t32,
                                  subset=subset),
                len(batch.items) if subset is None else len(subset))
    return step


def _new_stats() -> dict:
    stats = dict.fromkeys(("files", "input_bytes", "output_bytes",
                           "skipped", "device_to_host_bytes"), 0)
    stats.update(dict.fromkeys(("read_seconds", "device_seconds",
                                "pack_wait_seconds"), 0.0))
    return stats


def _allreduce_histogram(hist: np.ndarray) -> np.ndarray:
    """Sum int64 histograms across the processes (gloo ``all_reduce``).
    The sum is exact in int64, so the JAX package's two 31-bit limbs are
    not needed; every process gets the same sum, and so the same global
    threshold."""
    import torch
    import torch.distributed as dist

    t = torch.from_numpy(np.ascontiguousarray(hist, np.int64))
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t.numpy()


def _iter_timestep_items(meta: common.RunMeta, t: int, lv_boxes,
                         lo: int, hi: int, base: int, giant_pred=None,
                         owned_out: "set | None" = None):
    """This timestep's (WorkItem, array) pairs whose global item index
    (``base`` is the timestep's first) falls in this process's ``[lo,
    hi)``, in (t, lev, box, comp) order.

    ``giant_pred(dims)`` (giant boxes split across processes): also yield
    the other processes' items of giant shapes, whose transform is
    collective; ``owned_out`` collects the in-slice WorkItems, the ones
    this process writes."""
    g = base
    for li in range(len(meta.levels)):
        for b in range(meta.counts[t][li]):
            arr = lv_boxes[li].boxes[b]
            for c, comp_idx in enumerate(meta.comp_idxs):
                mine = lo <= g < hi
                if mine or (giant_pred is not None
                            and giant_pred(arr.shape[1:])):
                    item = batching.WorkItem(t=t, level=li,
                                             comp_idx=comp_idx, box=b)
                    if mine and owned_out is not None:
                        owned_out.add(item)
                    yield item, arr[c]
                g += 1


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


def _t_bytes_global(meta: common.RunMeta, eng, t: int) -> int:
    """Timestep t's padded batch bytes over every process's items, from
    the headers alone, so every process computes the same number: under
    ``giantmesh=global`` the ``globalcache`` admission decides whether the
    giant items' gathers and re-transforms run, which are collectives.
    It applies ``plan_batches``' pack and pad rules to the whole
    timestep; one process's share is no larger, so the budget still
    bounds each process's memory."""
    counts: dict = {}
    for lev in meta.dimensions[t]:
        for d in lev:
            counts[tuple(d)] = counts.get(tuple(d), 0) + len(meta.comp_idxs)
    return sum(batching.dense_batch_nbytes(n, shape, eng.pack_factor(shape),
                                           eng.pad_multiple_for(shape))
               for shape, n in counts.items())


def _compress_global(cfg: common.Config, meta: common.RunMeta, eng, packer,
                     have, timestep_batches, stats: dict,
                     crosshost: bool = False) -> int:
    """The two global-threshold passes; returns the bundle bytes closed.

    Pass 1 covers every item, also on resume: the histogram, and so the
    threshold, must be the one a fresh run derives.  Whole timesteps'
    coefficients stay in host RAM while the budget lasts (all or nothing
    per timestep, in order); past it, pass 1 fetches only the histogram
    and pass 2 re-reads and re-transforms the timestep.  ``crosshost``:
    giant items are collective (``giantmesh=global`` over several
    processes)."""
    n_times = len(meta.files)
    budget = (int(cfg.global_cache_bytes)
              if cfg.global_cache_bytes is not None
              else int(os.environ.get("WAVELET_TPU_GLOBALCACHE", 4 << 30)))
    cache: dict = {}        # t -> (coefficient ShapeBatches, owned set)
    cache_used = 0
    hist = np.zeros(threshold.EXP_HIST_BINS, np.int64)
    for t, (batches, owned) in _iter_prefetched(
            n_times, lambda t: timestep_batches(t, False), cfg.prefetch):
        t_bytes = (_t_bytes_global(meta, eng, t) if crosshost
                   else sum(b.data.nbytes for b in batches))
        keep_t = cache_used + t_bytes <= budget
        cbs = []
        for batch in batches:
            # a giant batch holds every process's giant items: each counts
            # in the histogram on its owner only
            with span("compress.device_step", stats, "device_seconds",
                      cpu=True, args=(*batch.shape, len(batch.items))):
                cb, h = eng.forward_hist_shapebatch(
                    batch, hist_items=_owned_subset(batch.items, owned),
                    fetch_coeffs=keep_t)
            hist += h
            if keep_t:
                cbs.append(cb)
                stats["device_to_host_bytes"] += cb.data.nbytes
        if keep_t:
            if batches:
                cache[t] = (cbs, owned)
            # crosshost: every process advances the budget alike, also
            # over a timestep with none of its items, or a later giant
            # timestep's admission would differ between processes
            if batches or crosshost:
                cache_used += t_bytes
    if cache or budget:
        log.info("globalcache: retained %d/%d timesteps' coefficients "
                 "(%.2f of %.2f GiB budget); pass 2 re-reads the rest",
                 len(cache), n_times, cache_used / 2**30, budget / 2**30)
    stats["global_cached_timesteps"] = len(cache)
    if mesh_lib.process_count() > 1:
        hist = _allreduce_histogram(hist)
    tval = threshold.threshold_from_histogram(hist, cfg.keep_fraction)
    log.info("Global magnitude threshold (keep_fraction=%s): %s",
             cfg.keep_fraction, tval)
    stats["global_threshold"] = float(tval)

    def pass2_batches(t):
        """Cached coefficient batches, or a re-read (popping frees each
        cached timestep as soon as it is consumed)."""
        cached = cache.pop(t, None)
        if cached is not None:
            return cached, True
        return timestep_batches(t, False), False

    bundle_bytes = 0
    for t, ((batches, owned), is_coeff) in _iter_prefetched(
            n_times, pass2_batches, cfg.prefetch):
        def step(batch, is_coeff=is_coeff, owned=owned):
            cb = batch
            if not is_coeff:
                cb = eng.forward_hist_shapebatch(batch)[0]
                stats["device_to_host_bytes"] += cb.data.nbytes
            subset = None
            if cfg.resume or owned is not None:
                mine = [i for i, it in enumerate(cb.items)
                        if owned is None or it in owned]
                subset = [i for i in mine if not (cfg.resume and _exists(
                    cfg.compressed_dir, cb.items[i], have))]
                stats["skipped"] += len(mine) - len(subset)
                if len(subset) == len(cb.items):
                    subset = None
            t32 = np.full(len(cb.items), tval, np.float32)
            n_packed = len(cb.items) if subset is None else len(subset)
            return (functools.partial(packer.pack, coeff_batch=cb, t32=t32,
                                      subset=subset), n_packed)

        _pack_overlapped(batches, step, cfg.compressed_dir, stats)
        bundle_bytes += _close(packer, stats, t)
    return bundle_bytes


def _close(packer, stats: dict, t: int | None = None) -> int:
    """Close timestep ``t``'s bundles (all: None), fsync included; ->
    their bytes."""
    with span("compress.close", stats, "close_seconds"):
        return packer.close_bundles(t)


def _compress_streaming(cfg: common.Config, meta: common.RunMeta,
                        stats: dict, mesh=None) -> None:
    """One-timestep-at-a-time compression: read -> device codec -> host
    pack -> free, adding to ``stats``.  Peak host memory is bounded by one
    timestep (two with ``prefetch=1``), plus the ``globalcache`` budget in
    global mode."""
    eng = engine.CodecEngine(device=cfg.device, scales=cfg.scales, mesh=mesh,
                             giant_box_bytes=cfg.giant_box_bytes,
                             giant_mesh_mode=cfg.giant_mesh, stats=stats)
    packer = engine.HostPacker(payload=cfg.payload, codec=cfg.codec,
                               xz_preset=cfg.xz_preset,
                               xz_delta=cfg.xz_delta,
                               archive_format=cfg.archive, stats=stats)
    have = (_have_index(cfg.compressed_dir, cfg.archive)
            if cfg.resume else None)
    # giant items are collective when giant boxes split across processes:
    # every process computes them, the owner alone writes each
    crosshost = (cfg.giant_mesh == "global"
                 and mesh_lib.process_count() > 1)
    giant_pred = ((lambda dims: eng.giant_ok(tuple(dims))) if crosshost
                  else None)

    ncomp = len(meta.comp_idxs)
    bases = np.concatenate(
        [[0], np.cumsum([sum(meta.counts[t]) * ncomp
                         for t in range(len(meta.files))])]).astype(int)
    sl = mesh_lib.process_local_slice(int(bases[-1]))
    lo, hi = sl.start, sl.stop

    def has_giant(t):
        return any(giant_pred(d) for lev in meta.dimensions[t] for d in lev)

    def timestep_batches(t, resume_filter: bool):
        """Read timestep t and plan this process's batches of it (data
        freed with them) -> (batches, the WorkItems this process writes,
        or None when it writes every item of its batches);
        ``resume_filter`` drops the items already in the archive, but not
        collective giant items.  A timestep with none of this process's
        items is not read, unless its giant items are collective."""
        if (bases[t + 1] <= lo or bases[t] >= hi) and not (
                crosshost and has_giant(t)):
            return [], None
        with span("compress.read", stats, "read_seconds", args=(t,)):
            lv_boxes = [plotfile.read_level(meta.files[t], lev,
                                            meta.comp_idxs)
                        for lev in meta.levels]
            owned = set() if crosshost else None
            items = list(_iter_timestep_items(meta, t, lv_boxes, lo, hi,
                                              int(bases[t]), giant_pred,
                                              owned))
            if resume_filter:
                kept = [p for p in items
                        if (crosshost and giant_pred(p[1].shape))
                        or not _exists(cfg.compressed_dir, p[0], have)]
                stats["skipped"] += len(items) - len(kept)
                items = kept
            batches = batching.plan_batches(items, pack_fn=eng.pack_factor,
                                            pad_fn=eng.pad_multiple_for)
        return batches, owned

    if cfg.threshold_mode == "global":
        bundle_bytes = _compress_global(cfg, meta, eng, packer, have,
                                        timestep_batches, stats, crosshost)
    else:
        bundle_bytes = 0
        for t, (batches, owned) in _iter_prefetched(
                len(meta.files), lambda t: timestep_batches(t, cfg.resume),
                cfg.prefetch):
            # timestep boundary: the link is quiescent here (the prefetch
            # worker only reads the disk), so a stale transfer=auto probe
            # can re-run without measuring the pipeline's own transfers
            if cfg.transfer == "auto":
                engine.CodecEngine.reprobe_link_if_stale()
            _pack_overlapped(batches, _box_step(eng, packer, cfg.keep,
                                                cfg.transfer, stats, owned),
                             cfg.compressed_dir, stats)
            # a finished timestep's bundle is closed right away: a crash
            # costs one timestep, like the per-file mode
            bundle_bytes += _close(packer, stats, t)
    if stats["skipped"]:
        log.info("Resume: skipped %d already-compressed items",
                 stats["skipped"])
    bundle_bytes += _close(packer, stats)
    if packer.archive_format == "bundle":
        stats["output_bytes"] = bundle_bytes


def compress_collected(run: common.RunData, keep: float, out_dir: str,
                       packer=None, threshold_mode: str = "box",
                       keep_fraction: float | None = None,
                       resume: bool = False, scales: int = 1,
                       payload: str = "f32", transfer: str = "dense",
                       archive_format: str = "files",
                       device: str = "cuda", mesh=None,
                       giant_box_bytes: int | None = None) -> dict:
    """Device codec + host pack for already-collected data; writes payloads
    only (no sidecars).  Returns stats.  ``threshold_mode`` is ``"box"``
    (the reference's per-(box, component) rule) or ``"global"`` (one
    magnitude threshold keeping ``keep_fraction`` of all coefficients,
    from the summed histogram).  In a multi-process run each process
    takes its ``process_local_slice`` of the items."""
    stats = _new_stats()
    eng = engine.CodecEngine(device=device, scales=scales, mesh=mesh,
                             giant_box_bytes=giant_box_bytes, stats=stats)
    packer = packer or engine.HostPacker(payload=payload,
                                         archive_format=archive_format,
                                         stats=stats)
    items = list(_iter_workitems(run))
    if mesh_lib.process_count() > 1:
        items = items[mesh_lib.process_local_slice(len(items))]
    skipped = 0
    have = _have_index(out_dir, packer.archive_format) if resume else None
    if resume and threshold_mode != "global":
        # global mode filters at the pack stage only: its histogram, and so
        # its threshold, must cover every item
        kept_items = [p for p in items if not _exists(out_dir, p[0], have)]
        skipped = len(items) - len(kept_items)
        if skipped:
            log.info("Resume: skipping %d already-compressed items", skipped)
        items = kept_items
    batches = batching.plan_batches(items, pack_fn=eng.pack_factor,
                                    pad_fn=eng.pad_multiple_for)
    if threshold_mode == "global":
        if keep_fraction is None:
            raise ValueError("global threshold mode requires keep_fraction")
        hist = np.zeros(threshold.EXP_HIST_BINS, np.int64)
        coeff_batches = []
        for batch in batches:
            cb, h = eng.forward_hist_shapebatch(batch)
            coeff_batches.append(cb)
            hist += h
        if mesh_lib.process_count() > 1:
            hist = _allreduce_histogram(hist)
        t = threshold.threshold_from_histogram(hist, keep_fraction)
        log.info("Global magnitude threshold (keep_fraction=%s): %s",
                 keep_fraction, t)
        n_files = in_bytes = out_bytes = 0
        for cb in coeff_batches:
            t32 = np.full(len(cb.items), t, np.float32)
            subset = None
            if resume:
                subset = [i for i, it in enumerate(cb.items)
                          if not _exists(out_dir, it, have)]
                skipped += len(cb.items) - len(subset)
            out_bytes += packer.pack(out_dir, cb, t32, subset=subset)
            n_files += len(subset) if subset is not None else len(cb.items)
            in_bytes += cb.n_valid * int(np.prod(cb.shape)) * 4
        bundle_bytes = packer.close_bundles()
        if packer.archive_format == "bundle":
            out_bytes = bundle_bytes
        return {"files": n_files, "input_bytes": in_bytes,
                "output_bytes": out_bytes, "global_threshold": float(t),
                "skipped": skipped}
    _pack_overlapped(batches, _box_step(eng, packer, keep, transfer, stats),
                     out_dir, stats)
    bundle_bytes = _close(packer, stats)
    if packer.archive_format == "bundle":
        stats["output_bytes"] = bundle_bytes
    stats["skipped"] = skipped
    return stats


def compress_run(cfg: common.Config, mesh=None) -> dict:
    """Full compression mode (modes.cpp:24-112), streaming per timestep;
    ``mesh`` as in :func:`compress_collected`."""
    engine.resolve_device(cfg.device)   # fail before touching the archive
    if cfg.threshold_mode == "global" and cfg.keep_fraction is None:
        raise ValueError("global threshold mode requires keep_fraction")
    files = common.format_files(cfg.data_dir, cfg.min_time, cfg.max_time)
    levels = common.format_levels(cfg.min_level, cfg.max_level)
    log.info("This run involves the following files:")
    for f in files:
        log.info("%s", f)

    log.info("Processing data...")
    stats = _new_stats()
    with phase_timer(
            "compress.setup",
            message=("Successfully processed data in %s seconds. "
                     "Beginning compression..."),
            sink=stats, key="preprocess_seconds"):
        meta = common.collect_run_meta(files, cfg.components, levels)
        os.makedirs(cfg.compressed_dir, exist_ok=True)
        write_sidecars_meta(meta, cfg.min_level, cfg.max_level,
                            cfg.compressed_dir)
        archive.write_meta(cfg.compressed_dir,
                           threshold_mode=cfg.threshold_mode,
                           keep=cfg.keep, keep_fraction=cfg.keep_fraction,
                           scales=cfg.scales, payload=cfg.payload,
                           codec=cfg.codec, xz_preset=cfg.xz_preset,
                           xz_delta=cfg.xz_delta,
                           archive_format=cfg.archive)

    with phase_timer(
            "compress.run", message="Compression completed in %s seconds.",
            sink=stats, key="compress_seconds") as ph:
        _compress_streaming(cfg, meta, stats, mesh)
        ph.nbytes = stats["input_bytes"]
    return stats
