"""Shared pipeline pieces: config, file/level discovery, run metadata and
in-memory run data.

Counterpart of ``wavelet_tpu.pipeline.common``, which is jax-free itself but
cannot be imported without jax: its package ``__init__`` imports the
compress pipeline.  The CLI contract mirrors the reference (argparse.cpp):
``datadir= minfile= maxfile= minlevel= maxlevel= components="..." keep=
compresseddir= out=`` plus ``-c``/``-d``/``-estimate``; missing keys
raise.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from wavelet_tpu_torch.io import archive, plotfile

__all__ = ["Config", "clean_string", "format_files", "format_levels",
           "RunData", "collect_run", "RunMeta", "collect_run_meta"]


@dataclass
class Config:
    """Reference ``Config`` (argparse.h:7-16) plus every extension key of
    the JAX package, under its names, and ``device``.  The device mesh is
    not a field: the pipelines take it as ``mesh=`` (CLI ``devices=N``),
    and a multi-process run joins its process group first (CLI
    ``coordinator=``, ``runtime/mesh.init_distributed``)."""

    data_dir: str = ""
    min_time: str = ""
    max_time: str = ""
    min_level: int = 0
    max_level: int = 0
    components: list = field(default_factory=list)
    keep: float = 0.999
    compressed_dir: str = ""
    out_dir: str = ""
    threshold_mode: str = "box"       # "box" (parity) | "global" (quantile)
    keep_fraction: float | None = None  # global mode: fraction of all
                                      #   coefficients to keep
    scales: int = 1                   # wavelet scales (1 = reference parity)
    global_cache_bytes: int | None = None  # global mode: host RAM budget
                                      #   for pass-1 coefficients (None =
                                      #   4 GiB, or WAVELET_TPU_GLOBALCACHE;
                                      #   0 = re-read every timestep)
    resume: bool = False              # skip already-written outputs
    payload: str = "f32"              # "f32" (parity) | "q16" (quantized)
    codec: str = "xz"                 # "xz" (parity) | "raw"
    xz_preset: int = 6                # xz preset (6 = reference parity)
    xz_delta: int = 0                 # xz delta-filter distance (0 = off)
    archive: str = "files"            # "files" (parity) | "bundle"
    levels_upto: int | None = None    # decompress: archive levels <= this
    out_precision: str = "f64"        # decompress: FAB width "f64" | "f32"
    prefetch: int = 0                 # 1 = overlap plotfile I/O with the
                                      #   codec (two timesteps in memory)
    transfer: str = "dense"           # "dense" | "sparse" (on-device
                                      #   compaction, kept pairs only over
                                      #   the link) | "auto" (sparse iff the
                                      #   measured link is slower than the
                                      #   device stage's breakeven,
                                      #   engine.transfer_mode)
    device_metrics: bool = False      # estimate: RMSE on the device (f32
                                      #   chunked sums) instead of the
                                      #   host's double accumulation
    fast_estimate: bool = False       # estimate in memory (no scratch dir)
    keep_sweep: list | None = None    # estimate: several keeps in one run
    keep_fraction_sweep: list | None = None  # estimate + global: several
                                      #   keepfractions in one run
    preview: int = 0                  # decompress: regenerate the low-band
                                      #   approximation at 1/2**preview
                                      #   resolution per axis (0 = full)
    giant_box_bytes: int | None = None  # boxes >= this many bytes split
                                      #   along X over a mesh of >= 2
                                      #   entries (None = 1 GiB or
                                      #   WAVELET_TPU_GIANTBOX; CLI
                                      #   giantbox=BYTES)
    giant_mesh: str = "local"         # "local": giant boxes split over
                                      #   this process's entries | "global":
                                      #   over every process's (CLI
                                      #   giantmesh=global)
    device: str = "cuda"              # "cuda" (kernels) | "cpu" (plain)


def clean_string(filename: str) -> int:
    """Digits-only numeric key of a file name; -1 if none (argparse.cpp:103-129)."""
    digits = "".join(ch for ch in filename if ch.isdigit())
    if not digits:
        return -1
    return int(digits)


def format_files(data_dir: str, min_time: str, max_time: str):
    """Timestep directories whose numeric key falls in [clean(min),
    clean(max)], sorted by key (argparse.cpp:133-166, keyed on the entry
    basename rather than the full path)."""
    first, last = clean_string(min_time), clean_string(max_time)
    files = [os.path.join(data_dir, e) for e in os.listdir(data_dir)
             if first <= clean_string(e) <= last]
    files.sort(key=lambda p: clean_string(os.path.basename(p)))
    if not files:
        raise ValueError(
            f"no plotfiles in {data_dir} match minfile={min_time} .. "
            f"maxfile={max_time}")
    return files


def format_levels(min_level: int, max_level: int):
    return list(range(int(min_level), int(max_level) + 1))


@dataclass
class RunMeta:
    """Sidecar-sufficient metadata of a run, without any box data: the
    streaming pipeline writes the sidecars from this, then reads FAB
    payloads one timestep at a time."""

    locations: list            # [t][lev] -> list of int triples
    dimensions: list           # [t][lev] -> list of int triples
    counts: list               # [t][lev] -> box count
    comp_idxs: list
    components: list           # selected names, Header order
    amrexinfo: archive.AMReXInfo
    files: list
    levels: list


def _select_ref_ratio(h, levels, fname: str) -> list:
    """The single per-axis ratio triple the archive stores, from the level
    boundaries the selection spans; non-uniform spanned ratios cannot be
    represented and are rejected."""
    used = h.ref_ratio[min(levels):max(levels)] if levels else []
    if len(set(used)) > 1:
        raise ValueError(
            f"plotfile {fname} refines with non-uniform ratios "
            f"{h.ref_ratio[:h.finest_level]} across the selected levels; "
            "the archive format stores a single ratio — restrict "
            "minlevel/maxlevel to a uniformly-refined range")
    r = used[0] if used else (h.ref_ratio[0] if h.ref_ratio else 2)
    return [r, r, r]


@dataclass
class RunData:
    """Everything one in-memory run needs (reference ``AllData``,
    box-structs.h:53-62): per (t, lev) box lists + geometry sidecar info.
    ``components`` holds the selected names in plotfile-Header order, the
    order of ``comp_idxs`` and of every per-component array."""

    levels_data: list          # [t][lev] -> plotfile.LevelBoxes
    comp_idxs: list            # header indices of selected components
    components: list           # selected names, Header order
    min_values: np.ndarray     # per component, over the whole run
    max_values: np.ndarray
    amrexinfo: archive.AMReXInfo
    files: list
    levels: list


def collect_run_meta(files, components, levels) -> RunMeta:
    """Metadata-only preprocessing pass (geometry of preprocess.cpp:107-307
    without the box-data copies)."""
    comp_idxs = None
    names_ordered = list(components)
    geom, true_times, lvl_steps = [], [], []
    ref_ratios = None
    base_dims = None
    locations, dimensions, counts = [], [], []
    for f in files:
        h = plotfile.read_header(f)
        if comp_idxs is None:
            comp_idxs = h.component_indices(components)
            names_ordered = [h.component_names[i] for i in comp_idxs]
            ref_ratios = _select_ref_ratio(h, levels, f)
            base_dims = h.domain_dims(0)
        geom.append(list(h.prob_lo) + list(h.prob_hi))
        true_times.append(np.longdouble(h.time_str))
        lvl_steps.append([h.level_steps[l] if l < len(h.level_steps) else 0
                          for l in levels])
        locs_t, dims_t, counts_t = [], [], []
        for lev in levels:
            locs, dims = plotfile.read_level_meta(f, lev)
            locs_t.append(locs)
            dims_t.append(dims)
            counts_t.append(len(locs))
        locations.append(locs_t)
        dimensions.append(dims_t)
        counts.append(counts_t)
    info = archive.AMReXInfo(geom, ref_ratios, true_times, lvl_steps,
                             base_dims[0], base_dims[1], base_dims[2])
    return RunMeta(locations=locations, dimensions=dimensions, counts=counts,
                   comp_idxs=comp_idxs, components=names_ordered,
                   amrexinfo=info, files=list(files), levels=list(levels))


def collect_run(files, components, levels) -> RunData:
    """Read the selected (timestep, level) slices of all plotfiles into
    memory (reference ``preprocess_data``, preprocess.cpp:107-307)."""
    levels_data = []
    comp_idxs = None
    minv = np.full(len(components), np.inf, np.float64)
    maxv = np.full(len(components), -np.inf, np.float64)
    geom, true_times, lvl_steps = [], [], []
    ref_ratios = None
    base_dims = None
    names_ordered = list(components)
    for f in files:
        h = plotfile.read_header(f)
        if comp_idxs is None:
            comp_idxs = h.component_indices(components)
            names_ordered = [h.component_names[i] for i in comp_idxs]
            ref_ratios = _select_ref_ratio(h, levels, f)
            base_dims = h.domain_dims(0)
        geom.append(list(h.prob_lo) + list(h.prob_hi))
        true_times.append(np.longdouble(h.time_str))
        lvl_steps.append([h.level_steps[l] if l < len(h.level_steps) else 0
                          for l in levels])
        per_lev = []
        for lev in levels:
            lv = plotfile.read_level(f, lev, comp_idxs)
            per_lev.append(lv)
            minv = np.minimum(minv, lv.min_values.astype(np.float64))
            maxv = np.maximum(maxv, lv.max_values.astype(np.float64))
        levels_data.append(per_lev)
    info = archive.AMReXInfo(geom, ref_ratios, true_times, lvl_steps,
                             base_dims[0], base_dims[1], base_dims[2])
    return RunData(levels_data=levels_data, comp_idxs=comp_idxs,
                   components=names_ordered,
                   min_values=minv.astype(np.float32),
                   max_values=maxv.astype(np.float32),
                   amrexinfo=info, files=list(files), levels=list(levels))
