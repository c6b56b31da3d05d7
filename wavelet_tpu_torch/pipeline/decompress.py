"""Decompression pipeline on PyTorch (reference: ``decompress(Config)``,
modes.cpp:115-204).

Counterpart of ``wavelet_tpu.pipeline.decompress`` for the main path:

  1. host: read the sidecars (runinfo/boxcounts/locations/dimensions/
     amrexinfo/meta);
  2. streaming loop, one timestep at a time: parallel read + xz decode +
     RLE scatter into coefficient batches (runtime/engine.HostPacker),
     device inverse Haar per shape bucket, then regenerate that timestep's
     plotfile byte-identically (io/plotfile.write_plotfile) and free.

Partial retrieval (timestep window, component subset, level prefix) and
``scales>1`` archives are ported (each box shape takes the pyramid depth
``eff_scales`` derives from its dims and the archive's ``scales``, as in
compression), and so is sparse transfer: ``transfer=sparse`` (or ``auto``
on a slow link) ships only the kept (position, value) pairs to the device
and scatters them there, for box-mode and global-mode archives alike.
Under ``WAVELET_TPU_LAYOUT=halves`` a bucket whose boxes pack
(``CodecEngine.pack_factor``) is unpacked into a lane-packed batch and
inverted by ``packed_inverse``; a sparse bucket still scatters logical
rows and comes back one box per row.

Preview (``cfg.preview = p``, CLI ``preview=p``) regenerates the wavelet
low band at ``1/2**p`` cells per axis on the same physical domain
(``CodecEngine.preview_shapebatch``); it composes with partial retrieval.
With ``mesh=`` the engine splits each bucket over the mesh (and giant
boxes along X); in a multi-process run (``runtime/mesh``) each process
regenerates its ``process_local_slice`` of the selected timesteps.  Under
``giantmesh=global`` giant boxes split over every process's entries and
their inverse is collective, so every process decodes every selected
timestep and yields (writes) only its own.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import dataclasses
import logging
import os
import time
import typing

import numpy as np
import torch

from wavelet_tpu_torch.io import archive, plotfile
from wavelet_tpu_torch.runtime import batching, carddecode
from wavelet_tpu_torch.runtime.debug import phase_timer, span
from wavelet_tpu_torch.pipeline import common
from wavelet_tpu_torch.runtime import engine
from wavelet_tpu_torch.runtime import mesh as mesh_lib

log = logging.getLogger("wavelet_tpu_torch")

__all__ = ["decompress_run", "iter_decompressed_timesteps"]


def _unpack_bucket(cfg, eng, packer, dims, bucket_items, arena=None):
    """HOST stage of one shape bucket: read + decode + the transport
    decision.  Returns ``(kind, payload, h2d)`` where kind is "dense"
    (payload = a filled coefficient ShapeBatch), "sparse" (payload =
    (shell batch, idx, vals)) or "preview" (payload = a logical-order
    coefficient batch; its h2d is decided by the device stage), and
    ``h2d`` the bytes the device stage ships — no device work happens
    here, so a prefetch worker can run it behind the previous bucket's
    inverse."""
    pad = eng.pad_multiple_for(dims)
    if cfg.preview:
        batch = batching.empty_batch(bucket_items, dims, pack=1,
                                     pad_multiple=pad, layout="halves",
                                     scales=eng.eff_scales(dims),
                                     arena=arena)
        packer.unpack_into(cfg.compressed_dir, batch)
        return "preview", batch, 0

    def dense_batch():
        return batching.empty_batch(bucket_items, dims,
                                    pack=eng.pack_factor(dims),
                                    pad_multiple=pad,
                                    layout=eng.coeff_layout(dims),
                                    scales=eng.eff_scales(dims),
                                    arena=arena)

    if eng.transfer_mode(dims, cfg.transfer, direction="h2d") == "sparse":
        batch = batching.ShapeBatch(shape=dims, data=None,
                                    items=bucket_items,
                                    n_valid=len(bucket_items))
        idx, vals = packer.unpack_sparse(cfg.compressed_dir, batch)
        dense_nbytes = batching.dense_batch_nbytes(
            len(bucket_items), dims, pack=eng.pack_factor(dims),
            pad_multiple=pad)
        if idx.nbytes + vals.nbytes < dense_nbytes:
            return "sparse", (batch, idx, vals), idx.nbytes + vals.nbytes
        # sparse transport must never ship MORE than dense: at high kept
        # fractions (pairs are 8 B/coefficient vs 4 B dense, padded to a
        # shared power-of-2 capacity) the pair stream can exceed the dense
        # rows — scatter the decoded pairs into dense rows on the host and
        # take the dense device path instead
        log.info("sparse transfer: kept fraction too high for shape %s "
                 "(%d pair bytes >= %d dense) — falling back to dense "
                 "transport", dims, idx.nbytes + vals.nbytes, dense_nbytes)
        dense = dense_batch()
        m = int(np.prod(dims))
        row = np.zeros(m, np.float32)
        for i in range(len(bucket_items)):
            k = idx[i] < m
            row[:] = 0.0
            row[idx[i][k]] = vals[i][k]
            dense.item_write(i, row.reshape(dims))
        return "dense", dense, dense.data.nbytes
    batch = dense_batch()
    packer.unpack_into(cfg.compressed_dir, batch)
    return "dense", batch, batch.data.nbytes


# a streamed chunk's rows hold at least this many bytes.  Regenerating
# buckets of 8-32^3 boxes on an H100 host (8 cores), chunks of 8 rows were
# 16-36% slower than one shot (medians of 7 passes): their device steps
# and assembles took 6-60x as long beside the decode workers.  At 4 MiB
# the same buckets read within noise of one shot (-2 to +10%), and
# buckets of 64^3 boxes gain ~20%.
_STREAM_MIN_CHUNK_BYTES = 4 << 20


def _stream_rows(cfg, eng, packer, dims, n_items) -> int:
    """Rows per chunk when the decode of a shape bucket of ``n_items``
    boxes streams into its device stage, or 0 when the bucket takes the
    one-shot path: streaming needs dense transport of unpacked rows (pack
    factor 1, not giant, no preview) and two chunks of members.  A
    chunk is one member for each of the packer's workers, or more to reach
    ``_STREAM_MIN_CHUNK_BYTES``, rounded up to the batch's padding
    quantum so that every chunk splits over the mesh as the bucket does."""
    if (cfg.preview or eng.giant_ok(dims)
            or batching.cap_pack(eng.pack_factor(dims), n_items,
                                 dims[-1]) > 1
            or eng.transfer_mode(dims, cfg.transfer,
                                 direction="h2d") == "sparse"):
        return 0
    box_bytes = int(np.prod(dims)) * 4
    rows = max(packer.workers, -(-_STREAM_MIN_CHUNK_BYTES // box_bytes))
    rows = batching.pad_to_multiple(rows, eng.pad_multiple_for(dims))
    return rows if n_items >= 2 * rows else 0


def _card_members(cfg, eng, packer, dims, items, sizes, head_s=0.0,
                  busy_blocks=0):
    """How many of a streamed bucket's ``items`` (largest first, of stored
    ``sizes``) the card decodes, from the end
    (:func:`carddecode.card_count`, the card's launch ``head_s`` seconds
    ahead of the bucket's host decode, ``busy_blocks`` of its blocks
    already running), and the host's predicted seconds for the rest (0
    while its rate is unknown): ``(0, ...)`` off a CUDA device, under a
    mesh, for ``q16`` or ``codec=raw`` payloads, and where a member is
    missing (its decode raises on the host reader)."""
    dev = eng.device
    if (dev.type != "cuda" or eng.mesh is not None or packer.payload != "f32"
            or packer.codec != "xz" or 0 in sizes):
        return 0, 0.0
    rates = carddecode.RATES
    card_bps, host_bps = rates.card_bps(dev), rates.host_bps()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    k = carddecode.card_count(
        sizes, host_bps=host_bps, workers=packer.workers, card_bps=card_bps,
        launch_s=rates.launch_s, head_s=head_s,
        sms=max(1, sms - busy_blocks))
    host_s = (carddecode.host_seconds(sizes[:len(sizes) - k], host_bps,
                                      packer.workers) if host_bps else 0.0)
    return k, host_s


class _CardPlan(typing.NamedTuple):
    """A streamed bucket's members in row order (largest first) and their
    stored sizes, the card's launch on their tail (None: the host decodes
    them all) and the host's predicted seconds for the rest."""

    items: list
    sizes: list
    card: object
    host_s: float


def _plan_card(cfg, eng, packer, dims, bucket_items, head_s=0.0,
               busy_blocks=0) -> _CardPlan:
    items = packer.largest_first(cfg.compressed_dir, bucket_items)
    sizes = packer.stored_sizes(cfg.compressed_dir, items)
    n_card, host_s = _card_members(cfg, eng, packer, dims, items, sizes,
                                   head_s, busy_blocks)
    card = None
    if n_card:
        card = carddecode.CardDecode(
            eng.device, dims,
            packer.read_blobs(cfg.compressed_dir, items[len(items) - n_card:]))
    return _CardPlan(items, sizes, card, host_s)


def _plan_cards(cfg, eng, packer, buckets, planned, head_s=0.0, blocks=0):
    """:func:`_plan_card` for each streamed bucket of ``buckets`` (``[(dims,
    items)]``, in the order their host decodes will run) that ``planned``
    lacks, launched now, each with the host seconds of the buckets before
    it as its head start, beside ``blocks`` blocks already launched; ->
    ``planned`` with them, the head start after the last bucket, and the
    blocks then launched."""
    planned = dict(planned)
    blocks += sum(len(p.card.sizes) for p in planned.values() if p.card)
    for dims, items in buckets:
        if not _stream_rows(cfg, eng, packer, dims, len(items)):
            continue
        if dims not in planned:
            planned[dims] = _plan_card(cfg, eng, packer, dims, items,
                                       head_s, blocks)
            card = planned[dims].card
            blocks += len(card.sizes) if card else 0
        head_s += planned[dims].host_s
    return planned, head_s, blocks


def _timestep_buckets(t, num_levels, counts, dimensions, comp_idxs) -> list:
    """Timestep ``t``'s items by box shape: ``[(dims, items)]``."""
    buckets = {}
    for li in range(num_levels):
        for b in range(counts[t][li]):
            dims = tuple(dimensions[t][li][b])
            for comp_idx in comp_idxs:
                buckets.setdefault(dims, []).append(
                    batching.WorkItem(t=t, level=li, comp_idx=comp_idx,
                                      box=b))
    return list(buckets.items())


def _decompress_timestep(cfg, eng, packer, comp_idxs, t, num_levels,
                         counts, dimensions, stats, arena=None, planned=None,
                         next_buckets=()):
    """Decode + inverse-transform every box of timestep ``t``.

    Returns ``(regen, ahead)``: ``regen`` [lev][box] -> (C, X, Y, Z) float32
    (``(C, X>>p, Y>>p, Z>>p)`` at ``preview=p``), and ``ahead`` the card
    plans (:class:`_CardPlan`) launched for ``next_buckets``, the next
    timestep's buckets, to pass to its call as ``planned``.  It adds the
    host-to-device bytes and the seconds of the host (unpack; span
    ``decompress.unpack``) and device (H2D, inverse kernel, D2H;
    ``decompress.device_step``) stages, and of copying each bucket's
    boxes into ``regen`` (``decompress.assemble``), to ``stats``.
    ``prefetch=1`` runs bucket i+1's host stage behind bucket i's device
    inverse.

    A bucket that :func:`_stream_rows` cuts into chunks streams instead:
    its members decode largest first on the packer's pool, and as each
    chunk of rows has decoded the calling thread runs that chunk's device
    stage and assemble while the pool decodes the later chunks.  Its
    ``unpack_seconds`` run from the bucket's start to the end of its last
    member's decode; the calling thread's waits for a chunk are spans of
    their own (``decompress.unpack_wait``, ``unpack_wait_seconds``); and
    ``unpack_overlap_seconds`` counts the seconds of its device steps and
    assembles that ran before its last member had decoded.

    A streamed bucket's smallest members may decode on the card
    (:func:`_plan_card`, ``runtime/carddecode``): they are its last rows,
    and once the card has finished they go through the device step from
    the device (``decompress.card_wait``).  The launches for this
    timestep's buckets that ``planned`` lacks, and then for
    ``next_buckets``, happen before any host decode starts: the next
    timestep's card members decode beside this timestep's host decode,
    with its predicted seconds as their head start."""
    comp_pos = {c: k for k, c in enumerate(comp_idxs)}
    ncomp = len(comp_idxs)
    regen = [[None] * counts[t][li] for li in range(num_levels)]
    order = _timestep_buckets(t, num_levels, counts, dimensions, comp_idxs)
    chunk_rows = [_stream_rows(cfg, eng, packer, dims, len(items))
                  for dims, items in order]
    # launched before any pool starts: their reads and staging on this
    # thread would wait for the cores the pools take
    planned, head_s, blocks = _plan_cards(cfg, eng, packer, order,
                                          planned or {})
    ahead, _, _ = _plan_cards(cfg, eng, packer, next_buckets, {}, head_s,
                              blocks)

    def host_stage(j):
        if chunk_rows[j]:
            return None         # the bucket's decode runs in stream_stage
        dims, bucket_items = order[j]
        with span("decompress.unpack", stats, "unpack_seconds",
                  args=(*dims, len(bucket_items))):
            return _unpack_bucket(cfg, eng, packer, dims, bucket_items,
                                  arena)

    def device_stage(dims, items, prepared):
        """-> the spans of the device step and the assemble."""
        kind, payload, h2d = prepared
        with span("decompress.device_step", stats, "device_seconds",
                  cpu=True, args=(*dims, len(items))) as step:
            if kind == "preview":
                arr, h2d = eng.preview_shapebatch(payload, cfg.preview)
                out_dims = tuple(arr.shape[1:])
                item = arr.__getitem__
            else:
                if kind == "sparse":
                    out = eng.decompress_shapebatch_sparse(*payload)
                elif kind == "card":
                    out = eng.decompress_device_rows(*payload)
                else:
                    out = eng.decompress_shapebatch(payload)
                out_dims = dims
                item = out.item_view
        stats["host_to_device_bytes"] += h2d
        with span("decompress.assemble", stats, "assemble_seconds",
                  args=(*dims, len(items))) as assemble:
            for i, it in enumerate(items):
                if regen[it.level][it.box] is None:
                    regen[it.level][it.box] = np.zeros(
                        (ncomp,) + out_dims, dtype=np.float32)
                regen[it.level][it.box][comp_pos[it.comp_idx]] = item(i)
        return step, assemble

    def card_rows(batch, card, lo, hi):
        """The card's rows ``[lo, hi)`` of ``batch``, once it has
        finished: the members it declined decode on the host reader into
        ``batch`` (raising its own ``ValueError`` on a corrupt member) and
        are copied into its rows; a member of the encoder's layout whose
        data or check the card rejected and the host reader decoded raises
        (:meth:`carddecode.CardDecode.kernel_faults`).  -> (the rows, the
        ``perf_counter`` at which the last of them decoded)."""
        rows = card.wait(stats)
        declined = [lo + i for i in np.flatnonzero(card.status)]
        if not declined:
            return rows, card.done
        with packer.unpack_stream(cfg.compressed_dir, batch,
                                  [(i, i + 1) for i in declined]) as host:
            for i, _ in host:
                rows[i - lo].copy_(torch.from_numpy(batch.data[i]))
        faults = card.kernel_faults()
        if faults:
            raise RuntimeError(
                "xzdec rejected members that the host reader decodes: "
                + ", ".join(f"{batch.items[lo + j]} (status "
                            f"{int(card.status[j])})" for j in faults))
        return rows, max(card.done, host.decoded)

    def stream_stage(j):
        dims, bucket_items = order[j]
        rows = chunk_rows[j]
        t0 = time.perf_counter()
        busy = []
        decoded = []
        with contextlib.ExitStack() as decoding:
            decoding.enter_context(span("decompress.unpack",
                                        args=(*dims, len(bucket_items))))
            items, sizes, card, _ = planned[dims]
            batch = batching.empty_batch(
                items, dims, pad_multiple=eng.pad_multiple_for(dims),
                layout=eng.coeff_layout(dims), scales=eng.eff_scales(dims),
                arena=arena)
            # the card takes the smallest members: the bucket's last rows
            n_card = len(card.sizes) if card else 0
            n_host = batch.data.shape[0] - n_card
            bounds = [(lo, min(lo + rows, n_host))
                      for lo in range(0, n_host, rows)]
            if card is not None:
                decoding.callback(card.close)
                h2d_card = card.h2d_bytes
            t_pool = time.perf_counter()
            stream = decoding.enter_context(packer.unpack_stream(
                cfg.compressed_dir, batch, bounds))
            steps = len(bounds) + (card is not None)
            host_left = len(bounds)
            for k in range(steps):
                # the card's rows as soon as it has finished, between host
                # chunks; else after the last
                if card is not None and (not host_left or card.ready()):
                    lo, hi = n_host, len(items)
                    on_card, done = card_rows(batch, card, lo, hi)
                    decoded.append(done)
                    card = None
                else:
                    with span("decompress.unpack_wait", stats,
                              "unpack_wait_seconds"):
                        lo, hi = next(stream)
                    host_left -= 1
                    on_card = None
                if k == steps - 1:
                    decoding.close()    # every member has decoded
                part_items = batch.items[lo:hi]
                part = dataclasses.replace(batch, data=batch.data[lo:hi],
                                           items=part_items,
                                           n_valid=len(part_items))
                busy += device_stage(
                    dims, part_items,
                    ("dense", part, part.data.nbytes) if on_card is None
                    else ("card", (part, on_card), h2d_card))
        end = max([stream.decoded] + decoded)
        stats["unpack_seconds"] += end - t0
        # the host's rate a core as its pool delivered it, for the card's
        # share of later buckets: stored bytes over the pool's wall times
        # the workers it kept
        n_pool = len(items) - n_card
        if n_pool:
            carddecode.RATES.add_host(
                sum(sizes[:n_pool]),
                (stream.decoded - t_pool) * min(packer.workers, n_pool))
        stats["unpack_overlap_seconds"] += sum(
            max(0.0, min(sp.start + sp.seconds, end) - sp.start)
            for sp in busy)
        return batch

    def run(j, prepared):
        if chunk_rows[j]:
            kind, payload = "dense", stream_stage(j)
        else:
            kind, payload = prepared[0], prepared[1]
            device_stage(*order[j], prepared)
        # the device stage fetched its result above, so the input buffer
        # can be recycled for a later bucket's unpack (BufferArena contract)
        if arena is not None and kind in ("dense", "preview"):
            arena.release(payload.data)

    if cfg.prefetch > 0 and len(order) > 1:
        with cf.ThreadPoolExecutor(1) as pool:
            nxt = pool.submit(host_stage, 0)
            for j in range(len(order)):
                prepared = nxt.result()
                if chunk_rows[j]:
                    # its pool holds the cores, and it adds to the stats
                    # keys a host stage adds to: prefetch after it
                    run(j, prepared)
                if j + 1 < len(order):
                    nxt = pool.submit(host_stage, j + 1)
                if not chunk_rows[j]:
                    run(j, prepared)
    else:
        for j in range(len(order)):
            run(j, host_stage(j))
    return regen, ahead


def iter_decompressed_timesteps(cfg: common.Config, mesh=None, stats=None):
    """Generator over regenerated timesteps: yields
    ``(t, plotfile_name, regen, locations_t, dimensions_t, info, amrex)``
    one timestep at a time, holding only that timestep's boxes.  A
    ``stats`` dict, if given, accumulates ``host_to_device_bytes``, the
    ``unpack_seconds`` / ``device_seconds`` of the two stages, the
    ``assemble_seconds`` of copying boxes out, a streamed bucket's
    ``unpack_wait_seconds`` and ``unpack_overlap_seconds``
    (:func:`_decompress_timestep`), the engine's device-step parts
    (``CodecEngine``: ``h2d_seconds``, ``launch_seconds``,
    ``d2h_seconds``) and the packer's member counts (``HostPacker``:
    ``unpack_cpu_seconds``, ``xz_decoded_bytes``,
    ``xz_decode_cpu_seconds``).  In a
    multi-process run only the timesteps this process owns are yielded
    (under ``giantmesh=global`` every process still decodes the others:
    the giant inverse is collective), so writing every yielded timestep
    is race-free.

    Partial retrieval: ``cfg.min_time``/``cfg.max_time`` select timesteps
    by the same numeric-key rule as compression, ``cfg.components`` a
    subset of the archived components, ``cfg.levels_upto`` an
    archive-level prefix.  Only the selected payloads are read.

    Preview: ``cfg.preview = p`` yields the low band at ``1/2**p`` cells
    per axis (the 2**p-cube block mean the Haar low-pass encodes), with
    locations, dimensions and the domain shifted down by ``p``; for ``p <=
    scales`` only the stored pyramid's corner crosses the host->device
    link."""
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

    # --- preview: low-band regeneration at 1/2**p ----------------------
    preview = cfg.preview
    if preview:
        f = 1 << preview
        base = (amrex.x_dim, amrex.y_dim, amrex.z_dim)
        if any(d % f for d in base):
            raise ValueError(
                f"preview={preview} requires domain dims divisible by {f}; "
                f"archive domain is {base}")
        for t in sel_times:
            for li in range(num_levels):
                for b in range(counts[t][li]):
                    loc = locations[t][li][b]
                    dd = dimensions[t][li][b]
                    if any(v % f for v in loc) or any(v % f for v in dd):
                        raise ValueError(
                            f"preview={preview} requires box locations and "
                            f"dims divisible by {f}; timestep {t} level "
                            f"{li} box {b} has loc={loc} dims={dd}")
        # the same physical domain over a 2**p-coarser index space: cells
        # grow 2**p per axis; geometry, times and steps are unchanged
        amrex = archive.AMReXInfo(
            amrex.geomcellinfo, amrex.ref_ratios, amrex.true_times,
            amrex.level_steps, amrex.x_dim >> preview,
            amrex.y_dim >> preview, amrex.z_dim >> preview)
        log.info("Preview mode: regenerating the wavelet low band at "
                 "1/%d resolution per axis", f)

    if stats is None:
        stats = {}
    packer = engine.HostPacker(payload=meta.get("payload", "f32"),
                               codec=meta.get("codec", "xz"),
                               archive_format=meta.get("archive", "files"),
                               stats=stats)
    eng = engine.CodecEngine(device=cfg.device,
                             scales=meta.get("scales", 1), mesh=mesh,
                             giant_box_bytes=cfg.giant_box_bytes,
                             giant_mesh_mode=cfg.giant_mesh, stats=stats)
    # timesteps are independent outputs (one plotfile directory each), so
    # each process of a multi-process run takes a contiguous slice; under
    # giantmesh=global it decodes them all (the giant inverse is a
    # collective) and yields only its slice
    owned_times = None
    if mesh_lib.process_count() > 1:
        sl = mesh_lib.process_local_slice(len(sel_times))
        if cfg.giant_mesh == "global":
            owned_times = set(sel_times[sl])
            stats["owned_times"] = owned_times
        else:
            sel_times = sel_times[sl]
    arena = batching.BufferArena()   # same shape buckets recur every step
    stats.setdefault("host_to_device_bytes", 0)
    stats.setdefault("unpack_seconds", 0.0)
    stats.setdefault("device_seconds", 0.0)
    stats.setdefault("assemble_seconds", 0.0)
    stats.setdefault("unpack_overlap_seconds", 0.0)
    for key in ("card_decoded_members", "card_decoded_bytes",
                "card_declined_members", "card_decode_seconds"):
        stats.setdefault(key, 0)
    planned = {}        # the card's launches for the next timestep
    for i, t in enumerate(sel_times):
        # timestep boundary: the link is quiescent here (the prefetch
        # worker only writes plotfiles), so a stale transfer=auto probe
        # can re-run without measuring the pipeline's own transfers
        arena.new_generation()
        if cfg.transfer == "auto":
            engine.CodecEngine.reprobe_link_if_stale()
        nxt = (_timestep_buckets(sel_times[i + 1], num_levels, counts,
                                 dimensions, comp_idxs)
               if i + 1 < len(sel_times) else ())
        regen, planned = _decompress_timestep(
            cfg, eng, packer, comp_idxs, t, num_levels, counts, dimensions,
            stats, arena=arena, planned=planned, next_buckets=nxt)
        if owned_times is not None and t not in owned_times:
            # decoded only to take part in the giant inverse; the gate is
            # here so that no consumer of this iterator writes another
            # process's timestep
            continue
        name = os.path.join(cfg.out_dir, os.path.basename(info.files[t]))
        if preview:
            locs_t = [[tuple(v >> preview for v in loc)
                       for loc in locations[t][li]]
                      for li in range(num_levels)]
            dims_t = [[tuple(v >> preview for v in dd)
                       for dd in dimensions[t][li]]
                      for li in range(num_levels)]
        else:
            locs_t = locations[t][:num_levels]
            dims_t = dimensions[t][:num_levels]
        yield (t, name, regen, locs_t, dims_t, sel_info, amrex)


def decompress_run(cfg: common.Config, mesh=None) -> dict:
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
            "decompress.run",
            message="Decompression completed in %s seconds.",
            sink=stats, key="decompress_seconds"), \
            cf.ThreadPoolExecutor(1) as write_pool:
        # prefetch=1: timestep t's plotfile write runs on the worker while
        # t+1 decodes; the single worker keeps writes ordered
        pending = None
        for (t, name, regen, locs_t, dims_t, rinfo, amrex) in \
                iter_decompressed_timesteps(cfg, mesh, stats=stats):
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
            with span("decompress.write", stats, "write_seconds"):
                if cfg.prefetch > 0:
                    if pending is not None:
                        pending.result()
                    pending = write_pool.submit(*job)
                else:
                    job[0](*job[1:])
            n_boxes += sum(len(per) for per in regen)
            n_times += 1
        if pending is not None:
            with span("decompress.write", stats, "write_seconds"):
                pending.result()
    log.info("Sucessfully wrote plotfiles.")
    stats.pop("owned_times", None)   # the iterator's write gate, no stat
    stats.update({"times": n_times,
                  "levels": stats.pop("levels_selected", num_levels),
                  "boxes": n_boxes})
    return stats
