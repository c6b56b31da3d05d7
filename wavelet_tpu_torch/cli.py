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
    python -m wavelet_tpu_torch.cli compresseddir=out/ out=prev/ \
        preview=1 -d
    python -m wavelet_tpu_torch.cli ... devices=2 giantbox=268435456 -c
    python -m wavelet_tpu_torch.cli ... coordinator=127.0.0.1:29500 \
        processes=2 processid=0 -c      # and processid=1 in a second process
    python -m wavelet_tpu_torch.cli ... giantbox=268435456 \
        giantmesh=global coordinator=... processes=2 processid=I -c

``transfer=dense|sparse|auto`` works on ``-c`` and ``-d``.  ``devices=N``
runs over a mesh of N entries (``cuda:0..N-1``, or N CPU entries with
``device=cpu``); ``coordinator=`` joins a gloo process group of
``processes=`` processes.  A process's local rank L is the number of
lower ranks on its host: it works on ``cuda:(L % cards)``, or with
``devices=N`` on its host's cards ``L*N .. L*N+N-1`` (which must exist).
``giantmesh=global`` splits giant boxes over every process's entries.
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
      preview=p (-d: the low band at 1/2^p resolution per axis)
      devices=N (a mesh of N devices: cuda:0..N-1, offset by the local
      rank * N in a process group, or N CPU entries with device=cpu)
      giantbox=BYTES (boxes >= this split WITHIN the box along X over the
      mesh; default 1 GiB; needs devices=N > 1, several cards per process
      or giantmesh=global)
      giantmesh=local|global (global: giant boxes split over every
      process's entries, for boxes beyond one process's devices)
      coordinator=host:port processes=N processid=I (multi-process, gloo)
      profile=DIR (torch.profiler trace)
Sweeps (-estimate only): keep="k1 k2 ..." or keepfraction="f1 f2 ..."
Kernel route: WAVELET_TPU_LAYOUT=auto|interleaved|halves (halves: the
lane-packed kernels at scales=1)
"""

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

    def giantbox_key():
        if "giantbox" not in kv:
            return None
        v = int(kv["giantbox"])
        if v <= 0:
            raise SystemExit(f"giantbox={kv['giantbox']} must be a "
                             "positive byte count")
        return v

    def giantmesh_key():
        v = kv.get("giantmesh", "local")
        if v not in ("local", "global"):
            raise SystemExit(f"Unknown giantmesh={v!r} (local|global)")
        return v

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
    cfg.giant_box_bytes = giantbox_key()
    if mode in ("c", "estimate", "d"):
        cfg.giant_mesh = giantmesh_key()
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
        cfg.preview = int(kv.get("preview", "0"))
        if cfg.preview < 0:
            raise SystemExit(f"preview={cfg.preview} must be >= 0")
        if cfg.preview and cfg.transfer == "sparse":
            # preview ships only the small low-band corner already; the
            # pair transport has nothing left to save there
            raise SystemExit("preview mode uses the dense transfer "
                             "(drop transfer=sparse)")
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
    from wavelet_tpu_torch.runtime import debug
    from wavelet_tpu_torch.runtime import mesh as mesh_lib

    kv = _kv(argv)
    try:
        if kv.get("coordinator"):
            # multi-process: coordinator=host:port processid=I processes=N
            n, i = (int(kv[k]) if k in kv else None
                    for k in ("processes", "processid"))
            mesh_lib.init_distributed(kv["coordinator"], n, i)
        mesh = _mesh(cfg.device, int(kv.get("devices", "1")))
        if kv.get("coordinator") and cfg.device == "cuda":
            import torch

            mesh_lib.resolve_device("cuda")   # raises without CUDA
            # a bare "cuda" tensor lands where the process works: its
            # mesh's first card, else its local rank's card
            torch.cuda.set_device(mesh.devices[0] if mesh is not None
                                  else mesh_lib.local_cuda_index())
    except (KeyError, ValueError) as e:
        log.error("bad argument: %s", e)
        _leave_group()
        return 1

    try:
        with debug.maybe_profile(kv.get("profile")):
            if mode == "c":
                compress_run(cfg, mesh=mesh)
            elif mode == "estimate":
                estimate_run(cfg, mesh=mesh)
            elif mode == "check":
                if check_run(cfg)["errors"]:
                    return 1
            elif mode == "info":
                info_run(cfg)
            else:
                decompress_run(cfg, mesh=mesh)
    except (KeyError, ValueError, OSError) as e:
        # user-input problems (bad component name, missing/corrupt archive
        # files) get a clean error instead of a traceback
        log.error("%s", e)
        return 1
    finally:
        _leave_group()
    return 0


def _mesh(device: str, n_dev: int):
    """``devices=N``: a mesh of N cards (raising, as the JAX CLI does,
    when fewer exist), or of N CPU entries; None for N = 1.  In a process
    group, local rank L takes its host's cards ``L*N .. L*N+N-1``
    (``mesh.local_cards``), so the processes of one host spread over its
    cards as with ``devices=1``; cards beyond the host's are refused."""
    if n_dev <= 1:
        return None
    from wavelet_tpu_torch.runtime import mesh as mesh_lib

    if device == "cpu":
        return mesh_lib.data_mesh(["cpu"] * n_dev)
    return mesh_lib.data_mesh(mesh_lib.local_cards(n_dev))


def _leave_group() -> None:
    """Tear down the process group, if this run joined one."""
    from wavelet_tpu_torch.runtime import mesh as mesh_lib

    mesh_lib.leave_distributed()


if __name__ == "__main__":
    sys.exit(main())
