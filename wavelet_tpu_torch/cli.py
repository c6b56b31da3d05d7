"""Reference-compatible command line for the PyTorch port.

Same ``key=value`` grammar as the C++ tool and ``wavelet_tpu.cli`` for the
``-c`` / ``-d`` / ``-estimate`` / ``-check`` / ``-info`` modes, with the
JAX package's rules and messages for its extension keys, plus one key,
``device=cuda|cpu`` (default ``cuda``, which raises when CUDA is
unavailable)::

    python -m wavelet_tpu_torch.cli datadir=... minfile=plt00074 \
        maxfile=plt00075 minlevel=0 maxlevel=1 components="temp pressure" \
        keep=0.999 compresseddir=out/ device=cuda -c
    python -m wavelet_tpu_torch.cli ... thresholdmode=global \
        keepfraction=0.02 scales=2 compresseddir=out2/ -c
    python -m wavelet_tpu_torch.cli compresseddir=out/ out=regen/ -d
    python -m wavelet_tpu_torch.cli compresseddir=out/ out=regen/ \
        transfer=sparse -d
    python -m wavelet_tpu_torch.cli datadir=... minfile=plt00074 \
        minlevel=0 components="temp" keep="0.99 0.999" fastestimate=1 \
        -estimate
    python -m wavelet_tpu_torch.cli compresseddir=out/ -check

``transfer=dense|sparse|auto`` works on ``-c`` and ``-d``.  Keys not yet
ported (preview, multi-device and multi-process keys) raise
``NotImplementedError``.
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
  -c         compress     datadir= minfile= maxfile= minlevel= maxlevel=
                          components="..." keep= compresseddir=
  -d         decompress   compresseddir= out=
                          [minfile=/maxfile=/components=/maxlevel= partial
                           retrieval] [outprec=f64|f32 FAB real width]
  -estimate  quality/size estimate (compress keys; maxfile/maxlevel optional)
  -check     archive integrity validation        compresseddir=
  -info      archive summary (no decode)         compresseddir=

Keys: device=cuda|cpu (default cuda)  payload=f32|q16  codec=xz|raw
      xzpreset=N  xzdelta=D  archive=files|bundle  prefetch=0|1  resume=1
      scales=S (pyramid depth)  thresholdmode=box|global
      keepfraction=F (global: keep this fraction of all coefficients;
      keep= is then not needed)  globalcache=BYTES (global: host RAM for
      pass-1 coefficients, default 4 GiB or WAVELET_TPU_GLOBALCACHE;
      0 = always re-read)
      transfer=dense|sparse|auto (-c and -d; sparse: compact on the
      device, only kept (index, value) pairs cross the link; auto:
      sparse iff the measured link is below the device-stage breakeven)
      fastestimate=1 (-estimate in memory)  devicemetrics=1 (-estimate
      RMSE on the device)
Sweeps (-estimate only): keep="k1 k2 ..." or keepfraction="f1 f2 ..."
Kernel route: WAVELET_TPU_LAYOUT=auto|interleaved|halves (halves: the
lane-packed kernels at scales=1)
"""

# keys of wavelet_tpu.cli whose non-default values this port does not run
_UNPORTED = {"preview": "0", "devices": "1",
             "coordinator": None, "processes": None, "processid": None,
             "giantbox": None, "giantmesh": "local", "profile": None}


def _kv(args):
    out = {}
    for a in args:
        if "=" in a and not a.startswith("-"):
            k, v = a.split("=", 1)
            out[k] = v
    return out


def parse_argv(argv):
    """-> (mode, Config); mode in {'c', 'd', 'estimate', 'check',
    'info'}."""
    flags = {a for a in argv if a.startswith("-")}
    kv = _kv(argv)
    if "-h" in flags or "--help" in flags:
        raise SystemExit(_USAGE)
    if "-c" in flags:
        mode = "c"
    elif "-estimate" in flags:
        mode = "estimate"
    elif "-d" in flags:
        mode = "d"
    elif "-check" in flags:
        mode = "check"
    elif "-info" in flags:
        mode = "info"
    else:
        raise SystemExit("Specify a mode: -c for compression, -d for "
                         "decompression, -estimate for estimate mode, "
                         "-check for archive validation, or -info for an "
                         "archive summary! (-h for usage)")
    for key, default in _UNPORTED.items():
        if key in kv and kv[key] != default:
            raise NotImplementedError(
                f"{key}={kv[key]} is not yet ported to wavelet_tpu_torch")

    def need(key):
        if key not in kv:
            raise SystemExit(f"Missing {key}!")
        return kv[key]

    def transfer_key():
        t = kv.get("transfer", "dense")
        if t not in ("dense", "sparse", "auto"):
            # a typo'd transport would otherwise silently run dense
            raise SystemExit(f"Unknown transfer={t!r} (dense|sparse|auto)")
        return t

    def globalcache_key():
        if "globalcache" not in kv:
            return None
        v = int(kv["globalcache"])
        if v < 0:
            raise SystemExit(f"globalcache={kv['globalcache']} must be a "
                             "non-negative byte count (0 disables)")
        return v

    cfg = Config()
    cfg.device = kv.get("device", "cuda")
    if cfg.device not in ("cuda", "cpu"):
        raise SystemExit(f"Unknown device={cfg.device!r} (cuda|cpu)")
    cfg.prefetch = int(kv.get("prefetch", "0"))
    cfg.transfer = transfer_key()
    if mode in ("c", "estimate"):
        cfg.data_dir = need("datadir")
        cfg.min_time = need("minfile")
        cfg.max_time = (need("maxfile") if mode == "c"
                        else kv.get("maxfile", kv["minfile"]))
        cfg.min_level = int(need("minlevel"))
        cfg.max_level = (int(need("maxlevel")) if mode == "c"
                         else int(kv.get("maxlevel", kv["minlevel"])))
        cfg.components = need("components").split()
        if not cfg.components:
            raise SystemExit("components= must name at least one component")
        cfg.resume = kv.get("resume", "0") in ("1", "true", "yes")
        cfg.scales = int(kv.get("scales", "1"))
        cfg.global_cache_bytes = globalcache_key()
        cfg.device_metrics = kv.get("devicemetrics", "0") == "1"
        cfg.fast_estimate = kv.get("fastestimate", "0") == "1"
        cfg.threshold_mode = kv.get("thresholdmode", "box")
        if cfg.threshold_mode == "global":
            fracs = [float(v) for v in need("keepfraction").split()]
            if not fracs:
                raise SystemExit("Missing keepfraction!")
            if len(fracs) > 1:
                if mode != "estimate":
                    raise SystemExit(
                        "keepfraction sweep (several values) is only "
                        "valid with -estimate")
                cfg.keep_fraction_sweep = fracs
            cfg.keep_fraction = fracs[0]
            if len(kv.get("keep", "0.999").split()) > 1:
                raise SystemExit("keep sweep requires the box threshold "
                                 "mode (global mode thresholds by "
                                 "keepfraction)")
            cfg.keep = float(kv.get("keep", "0.999"))
        else:
            keeps = [float(v) for v in need("keep").split()]
            if not keeps:
                raise SystemExit("Missing keep!")
            if len(keeps) > 1:
                if mode != "estimate":
                    # a compression run writes ONE archive at ONE keep
                    raise SystemExit(
                        "keep sweep (several keep values) is only valid "
                        "with -estimate")
                cfg.keep_sweep = keeps
            cfg.keep = keeps[0]
        cfg.compressed_dir = (need("compresseddir") if mode == "c"
                              else kv.get("compresseddir", ""))
        cfg.payload = kv.get("payload", "f32")
        cfg.codec = kv.get("codec", "xz")
        cfg.xz_preset = int(kv.get("xzpreset", "6"))
        cfg.xz_delta = int(kv.get("xzdelta", "0"))
        cfg.archive = kv.get("archive", "files")
    elif mode in ("check", "info"):
        cfg.compressed_dir = need("compresseddir")
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

    from wavelet_tpu_torch.pipeline.check import check_run, info_run
    from wavelet_tpu_torch.pipeline.compress import compress_run
    from wavelet_tpu_torch.pipeline.decompress import decompress_run
    from wavelet_tpu_torch.pipeline.estimate import estimate_run

    try:
        if mode == "c":
            compress_run(cfg)
        elif mode == "estimate":
            estimate_run(cfg)
        elif mode == "check":
            if check_run(cfg)["errors"]:
                return 1
        elif mode == "info":
            info_run(cfg)
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
