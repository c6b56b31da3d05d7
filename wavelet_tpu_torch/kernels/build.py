"""Build the port's CUDA kernels with ``nvcc`` at first use and load them.

The sources in ``wavelet_tpu_torch/csrc/*.cu`` have a plain C interface,
so they compile in seconds without PyTorch's headers: one ``nvcc`` per
source, all started together, then one link into one shared library.  The
library goes to ``build/wavelet_tpu_torch/`` at the root of the checkout,
under a name keyed by a hash of the sources, headers and flags, and is
loaded with ``ctypes``.  Nothing is built when this module is imported.

Flags: ``sm_90a`` (Hopper), ``-O3``, and the arithmetic flags the codec's
bit-exactness needs — no FMA contraction, no flush of subnormals, IEEE
division.  ``--use_fast_math`` is never passed: it implies ``-ftz=true``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

__all__ = ["NVCC_FLAGS", "library", "build_seconds", "build_log"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "wavelet_tpu_torch")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "--fmad=false", "-ftz=false", "-prec-div=true",
              "-Xptxas=-v", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib = None
build_seconds = None     # wall time of the build (or load) in this process
build_log = ""           # nvcc's output (-Xptxas=-v: registers, spills)


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def _sources():
    srcs = sorted(glob.glob(os.path.join(_CSRC, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {_CSRC}")
    return srcs


def _lib_path(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + sorted(glob.glob(os.path.join(_CSRC, "*.cuh"))):
        h.update(os.path.basename(s).encode())
        with open(s, "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD_DIR, f"libwt_kernels_{h.hexdigest()[:16]}.so")


def _run_all(cmds) -> str:
    """Run the commands concurrently; -> their joined output.  Raises on
    the first that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + " ".join(cmd) + "\n" + out)
    return "".join(outs)


def _build(srcs, path: str) -> str:
    """Compile every source at once, link them into ``path``; -> nvcc's
    output."""
    tmp = f"{path}.{os.getpid()}"
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in srcs]
    try:
        log = _run_all([[_nvcc(), *NVCC_FLAGS, "-c", "-o", o, s]
                        for s, o in zip(srcs, objs)])
        log += _run_all([[_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o",
                          f"{tmp}.tmp", *objs]])
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    os.replace(f"{tmp}.tmp", path)   # concurrent builds never load a torn file
    return log


def _bind(lib) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.wt_error_string.argtypes = [i32]
    lib.wt_error_string.restype = ctypes.c_char_p
    for fn in (lib.wt_pyramid_scratch, lib.wt_pyramid_forward_parts):
        fn.argtypes = [i32, i32, i32, i32]
        fn.restype = ctypes.c_longlong
    lib.wt_pyramid_forward.argtypes = [vp] * 7 + [i32] * 5 + [vp]
    lib.wt_pyramid_forward.restype = i32
    lib.wt_forward_hist.argtypes = [vp] * 4 + [i32] * 5 + [vp]
    lib.wt_forward_hist.restype = i32
    lib.wt_pyramid_inverse.argtypes = [vp] * 3 + [i32] * 5 + [vp]
    lib.wt_pyramid_inverse.restype = i32
    lib.wt_compact_tiles.argtypes = [i32]
    lib.wt_compact_tiles.restype = i32
    lib.wt_compact_count.argtypes = [vp] * 3 + [i32] * 2 + [vp]
    lib.wt_compact_count.restype = i32
    lib.wt_compact_scatter.argtypes = [vp] * 5 + [i32] * 3 + [vp]
    lib.wt_compact_scatter.restype = i32
    lib.wt_packed_forward.argtypes = [vp] * 5 + [i32] * 5 + [vp]
    lib.wt_packed_forward.restype = i32
    lib.wt_packed_forward_hist.argtypes = [vp] * 3 + [i32] * 5 + [vp]
    lib.wt_packed_forward_hist.restype = i32
    lib.wt_packed_inverse.argtypes = [vp] * 2 + [i32] * 5 + [vp]
    lib.wt_packed_inverse.restype = i32


def library():
    """The loaded kernel library, compiled on the first call.  Raises if
    ``nvcc`` is missing or the build fails: there is no fallback."""
    global _lib, build_seconds, build_log
    with _lock:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        srcs = _sources()
        path = _lib_path(srcs)
        if not os.path.exists(path):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            build_log = _build(srcs, path)
        lib = ctypes.CDLL(path)
        _bind(lib)
        _lib = lib
        build_seconds = time.perf_counter() - t0
        return _lib
