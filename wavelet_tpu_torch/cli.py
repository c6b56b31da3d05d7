"""Reference-compatible command line for the PyTorch port.

Same ``key=value`` grammar as the C++ tool and ``wavelet_tpu.cli`` for the
``-c`` / ``-d`` modes, plus one key, ``device=cuda|cpu`` (default
``cuda``, which raises when CUDA is unavailable)::

    python -m wavelet_tpu_torch.cli datadir=... minfile=plt00074 \
        maxfile=plt00075 minlevel=0 maxlevel=1 components="temp pressure" \
        keep=0.999 compresseddir=out/ device=cuda -c
    python -m wavelet_tpu_torch.cli compresseddir=out/ out=regen/ -d

Modes and keys not yet ported (``-estimate``, ``-check``, ``-info``,
global thresholds, ``scales>1``, sparse transfer, preview, multi-device and
multi-process keys) raise ``NotImplementedError``.
"""

from __future__ import annotations

import logging
import os
import sys

from wavelet_tpu_torch.pipeline.common import Config

__all__ = ["main", "parse_argv"]

log = logging.getLogger("wavelet_tpu_torch")

_USAGE = """wavelet_tpu_torch — wavelet compression for AMReX plotfiles on PyTorch

Modes (one required):
  -c   compress     datadir= minfile= maxfile= minlevel= maxlevel=
                    components="..." keep= compresseddir=
  -d   decompress   compresseddir= out=
                    [minfile=/maxfile=/components=/maxlevel= partial
                     retrieval] [outprec=f64|f32 FAB real width]

Keys: device=cuda|cpu (default cuda)  payload=f32|q16  codec=xz|raw
      xzpreset=N  xzdelta=D  archive=files|bundle  prefetch=0|1  resume=1
"""

# keys of wavelet_tpu.cli whose non-default values this port does not run
_UNPORTED = {"thresholdmode": "box", "keepfraction": None, "scales": "1",
             "transfer": "dense", "preview": "0", "devices": "1",
             "coordinator": None, "processes": None, "processid": None,
             "giantbox": None, "giantmesh": "local", "globalcache": None,
             "fastestimate": "0", "devicemetrics": "0", "profile": None}


def _kv(args):
    out = {}
    for a in args:
        if "=" in a and not a.startswith("-"):
            k, v = a.split("=", 1)
            out[k] = v
    return out


def parse_argv(argv):
    """-> (mode, Config); mode in {'c', 'd'}."""
    flags = {a for a in argv if a.startswith("-")}
    kv = _kv(argv)
    if "-h" in flags or "--help" in flags:
        raise SystemExit(_USAGE)
    for other in ("-estimate", "-check", "-info"):
        if other in flags:
            raise NotImplementedError(
                f"{other} mode is not yet ported to wavelet_tpu_torch "
                "(use wavelet_tpu.cli)")
    if "-c" in flags:
        mode = "c"
    elif "-d" in flags:
        mode = "d"
    else:
        raise SystemExit("Specify a mode: -c for compression or -d for "
                         "decompression! (-h for usage)")
    for key, default in _UNPORTED.items():
        if key in kv and kv[key] != default:
            raise NotImplementedError(
                f"{key}={kv[key]} is not yet ported to wavelet_tpu_torch")

    def need(key):
        if key not in kv:
            raise SystemExit(f"Missing {key}!")
        return kv[key]

    cfg = Config()
    cfg.device = kv.get("device", "cuda")
    if cfg.device not in ("cuda", "cpu"):
        raise SystemExit(f"Unknown device={cfg.device!r} (cuda|cpu)")
    cfg.prefetch = int(kv.get("prefetch", "0"))
    if mode == "c":
        cfg.data_dir = need("datadir")
        cfg.min_time = need("minfile")
        cfg.max_time = need("maxfile")
        cfg.min_level = int(need("minlevel"))
        cfg.max_level = int(need("maxlevel"))
        cfg.components = need("components").split()
        if not cfg.components:
            raise SystemExit("components= must name at least one component")
        keeps = [float(v) for v in need("keep").split()]
        if len(keeps) != 1:
            raise SystemExit("keep= takes one value with -c")
        cfg.keep = keeps[0]
        cfg.compressed_dir = need("compresseddir")
        cfg.resume = kv.get("resume", "0") in ("1", "true", "yes")
        cfg.payload = kv.get("payload", "f32")
        cfg.codec = kv.get("codec", "xz")
        cfg.xz_preset = int(kv.get("xzpreset", "6"))
        cfg.xz_delta = int(kv.get("xzdelta", "0"))
        cfg.archive = kv.get("archive", "files")
    else:
        cfg.compressed_dir = need("compresseddir")
        cfg.out_dir = need("out")
        cfg.out_precision = kv.get("outprec", "f64")
        if cfg.out_precision not in ("f64", "f32"):
            raise SystemExit(
                f"Unknown outprec={cfg.out_precision!r} (f64|f32)")
        # partial retrieval: only selected timesteps / components / levels
        cfg.min_time = kv.get("minfile", "")
        cfg.max_time = kv.get("maxfile", "")
        if "components" in kv:
            cfg.components = kv["components"].split()
        if "maxlevel" in kv:
            cfg.levels_upto = int(kv["maxlevel"])
    return mode, cfg


def main(argv=None):
    level_name = os.environ.get("WAVELET_TPU_LOG", "info").upper()
    level = logging.getLevelName(level_name)
    if not isinstance(level, int):    # unknown name -> fail, don't coerce
        raise SystemExit(
            f"WAVELET_TPU_LOG={level_name!r} is not a log level "
            "(debug/info/warning/error)")
    logging.basicConfig(level=level,
                        format="[%(asctime)s] [%(levelname)s] %(message)s")
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        mode, cfg = parse_argv(argv)
    except (KeyError, ValueError) as e:
        # malformed numeric values (minlevel=abc, keep=x) are user-input
        # problems: a clean error, not a traceback from int()/float()
        log.error("bad argument: %s", e)
        return 1

    from wavelet_tpu_torch.pipeline.compress import compress_run
    from wavelet_tpu_torch.pipeline.decompress import decompress_run

    try:
        if mode == "c":
            compress_run(cfg)
        else:
            decompress_run(cfg)
    except (KeyError, ValueError, OSError) as e:
        # user-input problems (bad component name, missing/corrupt archive
        # files) get a clean error instead of a traceback
        log.error("%s", e)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
