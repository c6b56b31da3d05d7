"""Programmatic API: the CLI's ``-c`` and ``-d`` modes as plain calls::

    import wavelet_tpu_torch

    stats = wavelet_tpu_torch.compress(
        "/data", "/archive", min_time="plt00074", max_time="plt00075",
        min_level=0, max_level=1, components=["temp", "pressure"],
        keep=0.999, device="cuda")
    wavelet_tpu_torch.decompress("/archive", "/regen", device="cuda")

Global thresholds, pyramids and sparse transfer take the JAX package's
keyword names: ``threshold_mode="global", keep_fraction=0.02, scales=2,
global_cache_bytes=...``, ``transfer="dense"|"sparse"|"auto"`` (for both
calls), ``preview=p``, ``giant_box_bytes=`` and ``giant_mesh="global"``
(giant boxes split over every process's entries).  ``mesh=`` (a
:class:`~wavelet_tpu_torch.runtime.mesh.DeviceMesh` from
:func:`~wavelet_tpu_torch.runtime.mesh.data_mesh`, of ``device``'s type)
splits the batches over its entries, like the CLI's ``devices=N``; a
multi-process run joins its process group first
(:func:`~wavelet_tpu_torch.runtime.mesh.init_distributed`).  Every other
knob is a keyword named after its
:class:`~wavelet_tpu_torch.pipeline.common.Config` field; unknown names
raise ``TypeError``.  :func:`estimate` (CLI ``-estimate``), :func:`check`
(``-check``) and :func:`info` (``-info``) are the JAX package's calls of
the same names.  Each returns the pipeline's stats or result dict.
"""

from __future__ import annotations

from dataclasses import fields as _dc_fields

from wavelet_tpu_torch.pipeline import common as _common
from wavelet_tpu_torch.pipeline.check import check_run as _check_run
from wavelet_tpu_torch.pipeline.check import info_run as _info_run
from wavelet_tpu_torch.pipeline.compress import compress_run as _compress_run
from wavelet_tpu_torch.pipeline.decompress import \
    decompress_run as _decompress_run
from wavelet_tpu_torch.pipeline.estimate import estimate_run as _estimate_run

__all__ = ["compress", "decompress", "estimate", "check", "info"]

_CFG_FIELDS = {f.name for f in _dc_fields(_common.Config)}


def _build_config(base: dict, options: dict) -> _common.Config:
    cfg = _common.Config()
    for k, v in {**base, **options}.items():
        if k not in _CFG_FIELDS:
            raise TypeError(
                f"unknown option {k!r}; valid Config fields: "
                f"{sorted(_CFG_FIELDS)}")
        setattr(cfg, k, v)
    return cfg


def compress(data_dir: str, compressed_dir: str, *, min_time: str,
             max_time: str, components: list, min_level: int = 0,
             max_level: int = 0, keep: float = 0.999, device: str = "cuda",
             mesh=None, **options) -> dict:
    """Compress plotfiles ``min_time..max_time`` into an archive (CLI -c)."""
    cfg = _build_config(dict(
        data_dir=data_dir, compressed_dir=compressed_dir, min_time=min_time,
        max_time=max_time, components=list(components), min_level=min_level,
        max_level=max_level, keep=keep, device=device), options)
    return _compress_run(cfg, mesh=mesh)


def decompress(compressed_dir: str, out_dir: str, *, device: str = "cuda",
               mesh=None, **options) -> dict:
    """Regenerate plotfiles from an archive (CLI -d).  Partial retrieval
    via ``min_time=``/``max_time=``, ``components=[...]``,
    ``levels_upto=L``; ``preview=p`` regenerates the low band at 1/2**p
    resolution per axis; ``transfer=`` as for :func:`compress`."""
    cfg = _build_config(dict(compressed_dir=compressed_dir, out_dir=out_dir,
                             device=device), options)
    return _decompress_run(cfg, mesh=mesh)


def estimate(data_dir: str, *, min_time: str, components: list,
             max_time: str | None = None, min_level: int = 0,
             max_level: int | None = None, keep: float = 0.999,
             device: str = "cuda", mesh=None, **options) -> dict:
    """Quality/size estimate without keeping an archive (CLI -estimate).

    Sweeps: ``keep_sweep=[k1, k2, ...]`` (box mode) or
    ``keep_fraction_sweep=[f1, ...]`` with ``threshold_mode="global"``;
    ``fast_estimate=True`` skips the scratch archive, ``device_metrics=True``
    takes the RMSE on the device."""
    cfg = _build_config(dict(
        data_dir=data_dir, min_time=min_time,
        max_time=min_time if max_time is None else max_time,
        components=list(components), min_level=min_level,
        max_level=min_level if max_level is None else max_level,
        keep=keep, device=device), options)
    return _estimate_run(cfg, mesh=mesh)


def check(compressed_dir: str) -> dict:
    """Validate archive integrity without decompressing (CLI -check)."""
    return _check_run(_common.Config(compressed_dir=compressed_dir))


def info(compressed_dir: str) -> dict:
    """Summarize an archive from sidecar metadata alone (CLI -info)."""
    return _info_run(_common.Config(compressed_dir=compressed_dir))
