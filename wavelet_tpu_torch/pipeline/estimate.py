"""Estimate pipeline (reference: ``estimate(Config)``, modes.cpp:209-328).

One timestep (minfile), one level (minlevel), all selected components:
compress into a scratch dir, decompress, report per-component mean RMSE
(unweighted over boxes, the reference's estimator), adjusted loss
(RMSE / range over the estimated subset) and compressed size as a
percentage of the (component-adjusted) raw level size.

Extension: ``keep="0.99 0.999 0.9999"`` sweeps several keeps in ONE
invocation (the reference README's suggested workflow is one run per
keep).  With ``fastestimate=1`` the sweep shares the forward transform —
the threshold rule's data-dependent half (the signed absmax) is
keep-independent, so each extra keep costs only the masking/metrics pass.

The port's copy of ``wavelet_tpu/pipeline/estimate.py`` (``cfg.device``,
and ``mesh=`` as in the compress pipeline): the scratch path compresses
with ``compress.compress_collected`` and decompresses each shape bucket
with the engine's pack factor, so under ``WAVELET_TPU_LAYOUT=halves`` it
runs the lane-packed kernels.  ``devicemetrics=1`` takes the RMSE from
``CodecEngine.rmse_batch`` (float32 on the device) instead of the host's
double accumulation.  ``fastestimate=1`` stacks plain arrays, which cannot
take the giant-box split, so a run with giant boxes takes the scratch
path.  The estimate runs in one process.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import logging
import os
import tempfile

import numpy as np

from wavelet_tpu_torch.core import metrics, rle
from wavelet_tpu_torch.core import threshold as thr
from wavelet_tpu_torch.io import archive, plotfile
from wavelet_tpu_torch.pipeline import common, compress
from wavelet_tpu_torch.runtime import batching, engine
from wavelet_tpu_torch.runtime import mesh as mesh_lib

log = logging.getLogger("wavelet_tpu_torch")

__all__ = ["estimate_run"]


def _fast_buckets(run):
    """Shape-bucketed (box, comp_idx) pairs + stacked per-bucket data."""
    lv = run.levels_data[0][0]
    comp_pos = {c: k for k, c in enumerate(run.comp_idxs)}
    buckets = {}
    for b in range(len(lv.boxes)):
        dims = tuple(lv.dimensions[b])
        for comp_idx in run.comp_idxs:
            buckets.setdefault(dims, []).append((b, comp_idx))
    stacked = {dims: np.stack([lv.boxes[b][comp_pos[ci]]
                               for (b, ci) in pairs])
               for dims, pairs in buckets.items()}
    return lv, comp_pos, buckets, stacked


def _fast_codec_regen(run, cfg, eng, comp_pos, buckets, flats, t32s):
    """Masked coefficients -> serialized sizes -> device inverse -> regen.
    The compressed-size metric is the sum of the encoded blob lengths —
    numerically identical to ``dir_size(scratch)`` (st_size sums = blob
    lengths; for ``archive=bundle`` the container's exact magic + index +
    trailer overhead is added so the number still matches the disk
    path), and RMSE comes from the same masked coefficients, so every
    reported number matches the disk path exactly.  The items are encoded
    on a thread pool (``lzma`` releases the GIL), as the host packer
    does."""
    serialize = (archive.serialize_payload_q16 if cfg.payload == "q16"
                 else archive.serialize_payload)
    preset = archive.pack_preset(cfg.xz_preset, cfg.xz_delta)
    lv = run.levels_data[0][0]
    regen = [np.zeros_like(box) for box in lv.boxes]
    total_bytes = 0
    for dims, pairs in buckets.items():
        flat, t32 = flats[dims], t32s[dims]
        masked = np.where(np.abs(flat) > t32[:, None], flat,
                          np.float32(0.0))

        def encode(i, dims=dims, flat=flat, t32=t32, masked=masked):
            mask = np.abs(flat[i]) > t32[i]
            runs, vals = rle.rle_encode_mask(mask, flat[i])
            payload = serialize(dims, runs, vals)
            if cfg.payload == "q16":
                # the reconstruction must see the quantized values the
                # disk path would have decoded
                _shape, total, runs2, vals2 = \
                    archive.deserialize_payload_q16(payload)
                masked[i] = rle.rle_decode(runs2, vals2, total)
            return len(archive.encode_blob(payload, cfg.codec, preset))

        with cf.ThreadPoolExecutor(min(32, os.cpu_count() or 4)) as ex:
            total_bytes += sum(ex.map(encode, range(len(pairs))))
        recon = eng.decompress_batch(masked, dims)
        for i, (b, ci) in enumerate(pairs):
            regen[b][comp_pos[ci]] = recon[i]
    if cfg.archive == "bundle":
        # exact .wtb container bytes (magic + per-member index entry +
        # trailer; one bundle — single timestep, single process here), so
        # fastestimate=1 reports the same size the scratch/real bundle
        # path measures from disk
        from wavelet_tpu_torch.io import bundle as bundle_mod

        n_members = sum(len(p) for p in buckets.values())
        total_bytes += (len(bundle_mod.MAGIC)
                        + n_members * bundle_mod._INDEX_ENTRY.size
                        + bundle_mod._TRAILER.size)
    return regen, total_bytes


def _engine(cfg, mesh) -> engine.CodecEngine:
    return engine.CodecEngine(device=cfg.device, scales=cfg.scales,
                              mesh=mesh, giant_box_bytes=cfg.giant_box_bytes)


def _metrics_result(run, cfg, eng, regen, comp_size, files, levels,
                    keep: float, raw_size=None) -> dict:
    """Per-component mean RMSE (unweighted over boxes, modes.cpp:269-291),
    adjusted loss, and size percentage (modes.cpp:294-324); ``eng`` runs
    the RMSE under ``devicemetrics=1``.

    ``raw_size`` lets sweep callers hoist the os.walk over every raw FAB
    file out of the per-value loop."""
    lv = run.levels_data[0][0]
    if cfg.device_metrics:
        per_box = [eng.rmse_batch(a, p) for a, p in zip(lv.boxes, regen)]
    else:
        per_box = [metrics.rmse_per_box(a, p)
                   for a, p in zip(lv.boxes, regen)]
    mean_rmse = metrics.mean_rmse(per_box)
    result = {"components": {}, "keep": keep}
    for c, name in enumerate(run.components):
        loss = metrics.adjusted_loss(
            mean_rmse[c],
            float(run.max_values[c]) - float(run.min_values[c]))
        log.info("Predicted RMSE, %s = %s", name, mean_rmse[c])
        log.info("Predicted Adjusted loss, %s = %s", name, loss)
        result["components"][name] = {
            "rmse": float(mean_rmse[c]), "adjusted_loss": float(loss)}
    if raw_size is None:
        h = plotfile.read_header(files[0])
        raw_path = os.path.join(files[0], f"Level_{levels[0]}")
        raw_size = (metrics.dir_size(raw_path) / h.n_comp
                    * len(cfg.components))
    pct = comp_size / raw_size * 100.0
    log.info("Predicted compressed size: %s%%", pct)
    result["compressed_size_pct"] = pct
    return result


def _fast_estimate(run, cfg, mesh, files, levels) -> dict:
    """fastestimate=1: no scratch archive at all (metrics identical)."""
    eng = _engine(cfg, mesh)
    _lv, comp_pos, buckets, stacked = _fast_buckets(run)
    # sweep-invariant: one raw-size walk and one engine for every value
    hdr = plotfile.read_header(files[0])
    raw_size = (metrics.dir_size(os.path.join(files[0],
                                              f"Level_{levels[0]}"))
                / hdr.n_comp * len(cfg.components))
    if cfg.threshold_mode == "global":
        # ONE forward + histogram serves any number of keep fractions
        # (the fixed-bin histogram is fraction-independent)
        hist = np.zeros(thr.EXP_HIST_BINS, np.int64)
        flats = {}
        for dims, data in stacked.items():
            flat, h = eng.forward_hist_batch(data)
            flats[dims] = flat
            hist += h
        fracs = cfg.keep_fraction_sweep or [cfg.keep_fraction]
        sweep = {}
        for frac in fracs:
            tval = thr.threshold_from_histogram(hist, frac)
            t32s = {dims: np.full(len(buckets[dims]), tval, np.float32)
                    for dims in buckets}
            regen, comp_size = _fast_codec_regen(run, cfg, eng, comp_pos,
                                                 buckets, flats, t32s)
            log.info("Compression complete.")
            log.info("Decompression complete.")
            log.info("keep_fraction = %s (threshold %s):", frac, tval)
            r = _metrics_result(run, cfg, eng, regen, comp_size, files,
                                levels, cfg.keep, raw_size=raw_size)
            r["keep_fraction"] = float(frac)
            r["global_threshold"] = float(tval)
            sweep[repr(frac)] = r
        if len(fracs) == 1:
            return sweep[repr(fracs[0])]
        return {"keep_fraction_sweep": sweep}
    # box mode: ONE forward per bucket; each keep derives its thresholds
    # from the keep-independent signed absmax
    flats, signeds = {}, {}
    for dims, data in stacked.items():
        flats[dims], signeds[dims] = eng.forward_signed_batch(data)
    keeps = cfg.keep_sweep or [cfg.keep]
    sweep = {}
    for keep in keeps:
        t32s = {dims: thr.exact_threshold32(signeds[dims], keep)
                for dims in buckets}
        regen, comp_size = _fast_codec_regen(run, cfg, eng, comp_pos,
                                             buckets, flats, t32s)
        log.info("Compression complete.")
        log.info("Decompression complete.")
        log.info("keep = %s:", keep)
        sweep[repr(keep)] = _metrics_result(run, cfg, eng, regen,
                                            comp_size, files, levels, keep,
                                            raw_size=raw_size)
    if len(keeps) == 1:
        return sweep[repr(keeps[0])]
    return {"keep_sweep": sweep}


def _estimate_scratch(run, cfg, mesh, files, levels) -> dict:
    """Reference-shaped estimate: compress into a scratch dir, decompress,
    measure (modes.cpp:209-328)."""
    with tempfile.TemporaryDirectory() as scratch:
        packer = engine.HostPacker(payload=cfg.payload, codec=cfg.codec,
                                   xz_preset=cfg.xz_preset,
                                   xz_delta=cfg.xz_delta,
                                   archive_format=cfg.archive)
        cstats = compress.compress_collected(
            run, cfg.keep, scratch, packer=packer,
            threshold_mode=cfg.threshold_mode,
            keep_fraction=cfg.keep_fraction,
            scales=cfg.scales, payload=cfg.payload, device=cfg.device,
            mesh=mesh, giant_box_bytes=cfg.giant_box_bytes)
        log.info("Compression complete.")
        eng = _engine(cfg, mesh)
        lv = run.levels_data[0][0]
        buckets = {}
        for b in range(len(lv.boxes)):
            dims = tuple(lv.dimensions[b])
            for comp_idx in run.comp_idxs:
                buckets.setdefault(dims, []).append(
                    batching.WorkItem(t=0, level=0, comp_idx=comp_idx, box=b))
        comp_pos = {c: k for k, c in enumerate(run.comp_idxs)}
        regen = [np.zeros_like(box) for box in lv.boxes]
        for dims, items in buckets.items():
            # giant shapes are not padded (they split within the box)
            batch = batching.empty_batch(items, dims,
                                         pack=eng.pack_factor(dims),
                                         pad_multiple=eng.pad_multiple_for(
                                             dims),
                                         layout=eng.coeff_layout(dims),
                                         scales=eng.eff_scales(dims))
            packer.unpack_into(scratch, batch)
            out = eng.decompress_shapebatch(batch)
            for i, it in enumerate(items):
                regen[it.box][comp_pos[it.comp_idx]] = out.item_view(i)
        log.info("Decompression complete.")
        comp_size = metrics.dir_size(scratch)
        result = _metrics_result(run, cfg, eng, regen, comp_size, files,
                                 levels, cfg.keep)
        if cfg.threshold_mode == "global":
            # same result schema as the fast path's global rows
            result["keep_fraction"] = float(cfg.keep_fraction)
            result["global_threshold"] = float(
                cstats.get("global_threshold"))
        return result


def estimate_run(cfg: common.Config, mesh=None) -> dict:
    """Estimate mode (modes.cpp:209-328): -> the per-component RMSE and
    adjusted loss and the compressed size percentage, or a sweep of them.
    ``mesh`` splits the batches over its entries, and giant boxes along
    X."""
    engine.resolve_device(cfg.device)
    if mesh_lib.process_count() > 1:
        # the reference's estimate is serial (modes.cpp:209-328): every
        # process would read and estimate the same timestep
        raise ValueError("'-estimate' runs single-process; drop "
                         "coordinator=/processes= for the estimate "
                         "(compress/decompress are the multi-process "
                         "modes)")
    files = common.format_files(cfg.data_dir, cfg.min_time, cfg.min_time)
    levels = [cfg.min_level]

    run = common.collect_run(files, cfg.components, levels)

    keeps = cfg.keep_sweep or [cfg.keep]
    if len(keeps) > 1 and cfg.threshold_mode == "global":
        raise ValueError("keep sweep requires the box threshold mode "
                         "(global mode thresholds by keepfraction)")
    fracs = cfg.keep_fraction_sweep or []
    if fracs and cfg.threshold_mode != "global":
        # a ONE-element sweep must be rejected too: box-mode
        # compress_collected never reads keep_fraction, so it would
        # silently return a keep=cfg.keep box result labeled as the
        # user's keep-fraction run
        raise ValueError("keepfraction sweep requires "
                         "thresholdmode=global")
    if cfg.threshold_mode == "global" and cfg.keep_fraction is None \
            and not fracs:
        # the scratch path raises this inside compress_collected; the
        # fast path would otherwise die on `None * total` (TypeError)
        raise ValueError("global threshold mode requires keep_fraction")
    if cfg.fast_estimate:
        lv = run.levels_data[0][0]
        gate = _engine(cfg, mesh)
        giant_dims = {tuple(d) for d in lv.dimensions
                      if gate.giant_ok(tuple(d))}
        if giant_dims:
            log.info("fastestimate: boxes %s exceed giantbox — using the "
                     "scratch estimate path (it splits within the box)",
                     sorted(giant_dims))
        else:
            return _fast_estimate(run, cfg, mesh, files, levels)

    def scratch_sweep(values, field):
        """One _estimate_scratch per value, substituted into ``field`` —
        a single-element sweep is honored the same way the fast path
        honors it (not silently ignored)."""
        sweep = {}
        for v in values:
            log.info("%s = %s:", field, v)
            c2 = dataclasses.replace(cfg, keep_sweep=None,
                                     keep_fraction_sweep=None,
                                     **{field: v})
            sweep[repr(v)] = _estimate_scratch(run, c2, mesh, files, levels)
        return sweep

    if fracs:
        sweep = scratch_sweep(fracs, "keep_fraction")
        if len(fracs) == 1:
            return sweep[repr(fracs[0])]
        return {"keep_fraction_sweep": sweep}
    if len(keeps) == 1:
        c2 = dataclasses.replace(cfg, keep=keeps[0], keep_sweep=None)
        return _estimate_scratch(run, c2, mesh, files, levels)
    return {"keep_sweep": scratch_sweep(keeps, "keep")}
