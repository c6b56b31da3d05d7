"""Build the port's CUDA kernels with ``nvcc`` at first use and load them.

The sources in ``wavelet_tpu_torch/csrc/*.cu`` have a plain C interface,
so they compile in seconds without PyTorch's headers.  The shared library
goes to ``build/wavelet_tpu_torch/`` at the root of the checkout, under a
name keyed by a hash of the sources and flags, and is loaded with
``ctypes``.  Nothing is built when this module is imported.

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
              "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC"]

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
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD_DIR, f"libwt_kernels_{h.hexdigest()[:16]}.so")


def _bind(lib) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.wt_haar_forward_blocks.argtypes = [i32, i32, i32]
    lib.wt_haar_forward_blocks.restype = ctypes.c_longlong
    lib.wt_haar_forward.argtypes = [vp, vp, vp, vp, vp, vp,
                                    i32, i32, i32, i32, vp]
    lib.wt_haar_forward.restype = i32
    lib.wt_haar_inverse.argtypes = [vp, vp, i32, i32, i32, i32, vp]
    lib.wt_haar_inverse.restype = i32
    lib.wt_error_string.argtypes = [i32]
    lib.wt_error_string.restype = ctypes.c_char_p


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
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    "nvcc failed:\n" + " ".join(cmd) + "\n" + proc.stdout +
                    proc.stderr)
            build_log = proc.stdout + proc.stderr
            os.replace(tmp, path)   # concurrent builders never load a torn file
        lib = ctypes.CDLL(path)
        _bind(lib)
        _lib = lib
        build_seconds = time.perf_counter() - t0
        return _lib
