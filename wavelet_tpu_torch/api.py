"""Programmatic API: the CLI's ``-c`` and ``-d`` modes as plain calls::

    import wavelet_tpu_torch

    stats = wavelet_tpu_torch.compress(
        "/data", "/archive", min_time="plt00074", max_time="plt00075",
        min_level=0, max_level=1, components=["temp", "pressure"],
        keep=0.999, device="cuda")
    wavelet_tpu_torch.decompress("/archive", "/regen", device="cuda")

Every other knob is a keyword named after its
:class:`~wavelet_tpu_torch.pipeline.common.Config` field; unknown names
raise ``TypeError``.  Both return the pipeline's stats dict.
"""

from __future__ import annotations

from dataclasses import fields as _dc_fields

from wavelet_tpu_torch.pipeline import common as _common
from wavelet_tpu_torch.pipeline.compress import compress_run as _compress_run
from wavelet_tpu_torch.pipeline.decompress import \
    decompress_run as _decompress_run

__all__ = ["compress", "decompress"]

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
             **options) -> dict:
    """Compress plotfiles ``min_time..max_time`` into an archive (CLI -c)."""
    cfg = _build_config(dict(
        data_dir=data_dir, compressed_dir=compressed_dir, min_time=min_time,
        max_time=max_time, components=list(components), min_level=min_level,
        max_level=max_level, keep=keep, device=device), options)
    return _compress_run(cfg)


def decompress(compressed_dir: str, out_dir: str, *, device: str = "cuda",
               **options) -> dict:
    """Regenerate plotfiles from an archive (CLI -d).  Partial retrieval
    via ``min_time=``/``max_time=``, ``components=[...]``,
    ``levels_upto=L``."""
    cfg = _build_config(dict(compressed_dir=compressed_dir, out_dir=out_dir,
                             device=device), options)
    return _decompress_run(cfg)
