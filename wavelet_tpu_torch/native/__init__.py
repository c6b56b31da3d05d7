"""ctypes binding for the native host codec (native/wtc_codec.cpp).

The port's own copy of ``wavelet_tpu/native/__init__.py``,
unchanged but for its imports, so that the port imports nothing of
``wavelet_tpu``.

Loads ``native/libwtc_codec.so``, rebuilding it with the local toolchain if
missing or older than its source; otherwise :data:`lib` is None and callers
fall back to the NumPy/``lzma`` path in runtime/engine.py.  Disable with
``WAVELET_TPU_NATIVE=0``.

The strided ABI covers both the contiguous ``[N, XYZ]`` coefficient layout
and the TPU lane-packed ``[M, X, Y, P*Z]`` layout without host repacking.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

__all__ = ["available", "pack_batch", "unpack_batch",
           "pack_strided", "unpack_strided",
           "pack_indexed", "unpack_indexed",
           "pack_mapped", "unpack_mapped",
           "encode_strided", "encode_indexed", "encode_mapped",
           "unpack_strided_mem", "unpack_indexed_mem", "unpack_mapped_mem",
           "fab_from_boxes", "boxes_from_fab"]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SO_PATH = os.path.join(_REPO_ROOT, "native", "libwtc_codec.so")
_SRC_PATH = os.path.join(_REPO_ROOT, "native", "wtc_codec.cpp")

lib = None

_i64 = ctypes.c_int64
_pf = ctypes.POINTER(ctypes.c_float)
_pi32 = ctypes.POINTER(ctypes.c_int32)
_pi64 = ctypes.POINTER(ctypes.c_int64)
_pstr = ctypes.POINTER(ctypes.c_char_p)


def _try_load():
    global lib
    if os.environ.get("WAVELET_TPU_NATIVE", "1") == "0":
        return
    stale = (not os.path.exists(_SO_PATH)
             or (os.path.exists(_SRC_PATH)
                 and os.path.getmtime(_SO_PATH) < os.path.getmtime(_SRC_PATH)))
    if stale and os.path.exists(_SRC_PATH):
        # build to a per-process temp name, then atomic-rename: two
        # processes importing concurrently after a source change (multi-
        # process jax, pytest-xdist) must never CDLL a half-written .so —
        # a torn file with a fresh mtime would pass the staleness check
        # forever and silently pin every later run to the python packer
        tmp_so = f"{_SO_PATH}.{os.getpid()}.tmp"
        try:
            # native/build.sh is the single home of the compile flags —
            # a hardcoded copy here drifted from it once already
            subprocess.run(
                ["sh", os.path.join(_REPO_ROOT, "native", "build.sh"),
                 tmp_so],
                check=True, capture_output=True, timeout=120)
            os.replace(tmp_so, _SO_PATH)
        except Exception:
            try:
                os.remove(tmp_so)
            except OSError:
                pass
            return
    if not os.path.exists(_SO_PATH):
        return
    try:
        handle = ctypes.CDLL(_SO_PATH)
    except OSError:
        return
    try:
        _bind(handle)
    except AttributeError:
        # an .so built from older source (copied artifact / mtime tie
        # defeating the staleness check) lacks newer symbols: degrade to
        # the python packer instead of failing the whole package import
        return
    lib = handle


def _bind(handle):
    handle.wtc_pack_strided.restype = _i64
    handle.wtc_pack_strided.argtypes = [
        _pf, _pf, _i64, _i64, _i64, _i64, _pi64, _pi32, _pstr, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    handle.wtc_unpack_strided.restype = _i64
    handle.wtc_unpack_strided.argtypes = [
        _pstr, _i64, _i64, _i64, _i64, _pi64, _pf, _pi32, ctypes.c_int,
        ctypes.c_int, ctypes.c_int]
    handle.wtc_pack_indexed.restype = _i64
    handle.wtc_pack_indexed.argtypes = [
        _pf, _pf, _i64, _i64, _i64, _i64, _pi64, _pi64, _pi64, _pi64,
        _pi32, _pstr, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int]
    handle.wtc_unpack_indexed.restype = _i64
    handle.wtc_unpack_indexed.argtypes = [
        _pstr, _i64, _i64, _i64, _i64, _pi64, _pi64, _pi64, _pi64, _pf,
        _pi32, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    handle.wtc_pack_mapped.restype = _i64
    handle.wtc_pack_mapped.argtypes = [
        _pf, _pf, _i64, _i64, _pi64, _pi64, _pi32, _pstr, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    handle.wtc_unpack_mapped.restype = _i64
    handle.wtc_unpack_mapped.argtypes = [
        _pstr, _i64, _i64, _pi64, _pi64, _pf, _pi32, ctypes.c_int,
        ctypes.c_int, ctypes.c_int]
    # bundle-mode entry points: encode to per-item blobs / decode members
    # handed in as (pointer, size) pairs
    _pu8 = ctypes.POINTER(ctypes.c_uint8)
    _ppu8 = ctypes.POINTER(_pu8)
    handle.wtc_encode_strided.restype = _i64
    handle.wtc_encode_strided.argtypes = [
        _pf, _pf, _i64, _i64, _i64, _i64, _pi64, _pi32, _ppu8, _pi64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    handle.wtc_encode_indexed.restype = _i64
    handle.wtc_encode_indexed.argtypes = [
        _pf, _pf, _i64, _i64, _i64, _i64, _pi64, _pi64, _pi64, _pi64,
        _pi32, _ppu8, _pi64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int]
    handle.wtc_encode_mapped.restype = _i64
    handle.wtc_encode_mapped.argtypes = [
        _pf, _pf, _i64, _i64, _pi64, _pi64, _pi32, _ppu8, _pi64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    handle.wtc_free_blob.restype = None
    handle.wtc_free_blob.argtypes = [_pu8]
    handle.wtc_unpack_strided_mem.restype = _i64
    handle.wtc_unpack_strided_mem.argtypes = [
        _ppu8, _pi64, _i64, _i64, _i64, _i64, _pi64, _pf, _pi32,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    handle.wtc_unpack_indexed_mem.restype = _i64
    handle.wtc_unpack_indexed_mem.argtypes = [
        _ppu8, _pi64, _i64, _i64, _i64, _i64, _pi64, _pi64, _pi64, _pi64,
        _pf, _pi32, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    handle.wtc_unpack_mapped_mem.restype = _i64
    handle.wtc_unpack_mapped_mem.argtypes = [
        _ppu8, _pi64, _i64, _i64, _pi64, _pi64, _pf, _pi32,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    handle.wtc_fab_from_boxes.restype = _i64
    handle.wtc_fab_from_boxes.argtypes = [
        _pf, _i64, _i64, _i64, _i64, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int]
    handle.wtc_boxes_from_fab.restype = _i64
    handle.wtc_boxes_from_fab.argtypes = [
        ctypes.c_void_p, ctypes.c_int, _i64, _i64, _i64, _i64, _pf,
        ctypes.c_int]


_try_load()


def available() -> bool:
    return lib is not None


def _paths_array(paths):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [p.encode() for p in paths]
    return arr


_FMT = {"f32": 0, "q16": 1}
_CODEC = {"xz": 0, "raw": 1}


def _check_total(shape):
    """Same guard as the Python packer (io/archive.py): the reference's
    int32 payload-header total cannot represent bigger boxes, and the
    native serializer would silently truncate instead of erroring."""
    total = 1
    for v in shape:
        total *= int(v)
    if total > 0x7FFFFFFF:
        raise ValueError(
            f"box {'x'.join(str(int(v)) for v in shape)} has {total} "
            "coefficients — beyond the archive format's int32 total; "
            "split the domain into smaller boxes")


def pack_strided(coeffs: np.ndarray, t32: np.ndarray, shape, paths,
                 rows: int, row_len: int, row_stride: int,
                 offsets: np.ndarray, n_threads: int = 0,
                 payload: str = "f32", codec: str = "xz",
                 preset: int = 6) -> int:
    """Threshold+RLE+xz+write items out of a strided float32 buffer.

    Item i = ``rows`` runs of ``row_len`` floats, ``row_stride`` apart, at
    ``coeffs.ravel()[offsets[i]]``.  Returns total compressed bytes."""
    coeffs = np.ascontiguousarray(coeffs, dtype=np.float32)
    t32 = np.ascontiguousarray(t32, dtype=np.float32)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    _check_total(shape)
    shp = np.asarray(shape, dtype=np.int32)
    ret = lib.wtc_pack_strided(
        coeffs.ctypes.data_as(_pf), t32.ctypes.data_as(_pf),
        len(paths), rows, row_len, row_stride,
        offsets.ctypes.data_as(_pi64), shp.ctypes.data_as(_pi32),
        _paths_array(list(paths)), n_threads, _FMT[payload],
        _CODEC[codec], int(preset))
    if ret < 0:
        raise IOError(f"native pack failed at item {-(ret + 1)}")
    return int(ret)


def unpack_strided(paths, dest: np.ndarray, rows: int, row_len: int,
                   row_stride: int, offsets: np.ndarray,
                   n_threads: int = 0, payload: str = "f32",
                   codec: str = "xz") -> np.ndarray:
    """Read .xz payloads into a strided float32 destination (regions are
    zero-filled first).  Returns the per-item shapes int32 [N, 3]."""
    assert dest.dtype == np.float32 and dest.flags.c_contiguous
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    n = len(paths)
    shapes = np.empty((n, 3), dtype=np.int32)
    ret = lib.wtc_unpack_strided(
        _paths_array(list(paths)), n, rows, row_len, row_stride,
        offsets.ctypes.data_as(_pi64), dest.ctypes.data_as(_pf),
        shapes.ctypes.data_as(_pi32), n_threads, _FMT[payload],
        _CODEC[codec])
    if ret < 0:
        raise IOError(f"native unpack failed at item {-(ret + 1)}")
    return shapes


def pack_batch(coeffs: np.ndarray, t32: np.ndarray, shape, paths,
               n_threads: int = 0) -> int:
    """Contiguous [N, XYZ] convenience wrapper over :func:`pack_strided`."""
    coeffs = np.ascontiguousarray(coeffs, dtype=np.float32)
    n, m = coeffs.shape
    offsets = np.arange(n, dtype=np.int64) * m
    return pack_strided(coeffs, t32, shape, paths, 1, m, m, offsets,
                        n_threads)


def unpack_batch(paths, n_coeffs: int, n_threads: int = 0):
    """Contiguous wrapper: -> (flat [N, n_coeffs] f32, shapes [N, 3])."""
    n = len(paths)
    out = np.empty((n, n_coeffs), dtype=np.float32)
    offsets = np.arange(n, dtype=np.int64) * n_coeffs
    shapes = unpack_strided(paths, out, 1, n_coeffs, n_coeffs, offsets,
                            n_threads)
    return out, shapes


def pack_indexed(coeffs: np.ndarray, t32: np.ndarray, shape, paths,
                 ix: np.ndarray, iy: np.ndarray, iz: np.ndarray,
                 offsets: np.ndarray, n_threads: int = 0,
                 payload: str = "f32", codec: str = "xz",
                 preset: int = 6) -> int:
    """Pack items whose logical (reference-order) coefficient (a, b, c)
    lives at ``coeffs.ravel()[offsets[i] + ix[a] + iy[b] + iz[c]]`` —
    the general layout walk (permuted/interleaved device layouts)."""
    coeffs = np.ascontiguousarray(coeffs, dtype=np.float32)
    t32 = np.ascontiguousarray(t32, dtype=np.float32)
    ix = np.ascontiguousarray(ix, dtype=np.int64)
    iy = np.ascontiguousarray(iy, dtype=np.int64)
    iz = np.ascontiguousarray(iz, dtype=np.int64)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    _check_total(shape)
    shp = np.asarray(shape, dtype=np.int32)
    ret = lib.wtc_pack_indexed(
        coeffs.ctypes.data_as(_pf), t32.ctypes.data_as(_pf),
        len(paths), len(ix), len(iy), len(iz),
        ix.ctypes.data_as(_pi64), iy.ctypes.data_as(_pi64),
        iz.ctypes.data_as(_pi64), offsets.ctypes.data_as(_pi64),
        shp.ctypes.data_as(_pi32), _paths_array(list(paths)), n_threads,
        _FMT[payload], _CODEC[codec], int(preset))
    if ret < 0:
        raise IOError(f"native pack failed at item {-(ret + 1)}")
    return int(ret)


def unpack_indexed(paths, dest: np.ndarray, ix: np.ndarray, iy: np.ndarray,
                   iz: np.ndarray, offsets: np.ndarray, n_threads: int = 0,
                   payload: str = "f32", codec: str = "xz") -> np.ndarray:
    """Scatter payloads into an indexed destination layout (regions are
    zero-filled first).  Returns per-item shapes int32 [N, 3]."""
    assert dest.dtype == np.float32 and dest.flags.c_contiguous
    ix = np.ascontiguousarray(ix, dtype=np.int64)
    iy = np.ascontiguousarray(iy, dtype=np.int64)
    iz = np.ascontiguousarray(iz, dtype=np.int64)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    n = len(paths)
    shapes = np.empty((n, 3), dtype=np.int32)
    ret = lib.wtc_unpack_indexed(
        _paths_array(list(paths)), n, len(ix), len(iy), len(iz),
        ix.ctypes.data_as(_pi64), iy.ctypes.data_as(_pi64),
        iz.ctypes.data_as(_pi64), offsets.ctypes.data_as(_pi64),
        dest.ctypes.data_as(_pf), shapes.ctypes.data_as(_pi32), n_threads,
        _FMT[payload], _CODEC[codec])
    if ret < 0:
        raise IOError(f"native unpack failed at item {-(ret + 1)}")
    return shapes


def pack_mapped(coeffs: np.ndarray, t32: np.ndarray, shape, paths,
                coeff_map: np.ndarray, offsets: np.ndarray,
                n_threads: int = 0, payload: str = "f32",
                codec: str = "xz", preset: int = 6) -> int:
    """Fully general layout walk: logical flat coefficient t of item i
    lives at ``coeffs.ravel()[offsets[i] + coeff_map[t]]`` (multi-scale
    interleaved layouts, whose map is not separable per axis)."""
    coeffs = np.ascontiguousarray(coeffs, dtype=np.float32)
    t32 = np.ascontiguousarray(t32, dtype=np.float32)
    coeff_map = np.ascontiguousarray(coeff_map, dtype=np.int64)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    _check_total(shape)
    shp = np.asarray(shape, dtype=np.int32)
    ret = lib.wtc_pack_mapped(
        coeffs.ctypes.data_as(_pf), t32.ctypes.data_as(_pf),
        len(paths), len(coeff_map),
        coeff_map.ctypes.data_as(_pi64), offsets.ctypes.data_as(_pi64),
        shp.ctypes.data_as(_pi32), _paths_array(list(paths)), n_threads,
        _FMT[payload], _CODEC[codec], int(preset))
    if ret < 0:
        raise IOError(f"native pack failed at item {-(ret + 1)}")
    return int(ret)


def unpack_mapped(paths, dest: np.ndarray, coeff_map: np.ndarray,
                  offsets: np.ndarray, n_threads: int = 0,
                  payload: str = "f32", codec: str = "xz") -> np.ndarray:
    """Scatter payloads through a flat logical->physical map (regions
    zero-filled first).  Returns per-item shapes int32 [N, 3]."""
    assert dest.dtype == np.float32 and dest.flags.c_contiguous
    coeff_map = np.ascontiguousarray(coeff_map, dtype=np.int64)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    n = len(paths)
    shapes = np.empty((n, 3), dtype=np.int32)
    ret = lib.wtc_unpack_mapped(
        _paths_array(list(paths)), n, len(coeff_map),
        coeff_map.ctypes.data_as(_pi64), offsets.ctypes.data_as(_pi64),
        dest.ctypes.data_as(_pf), shapes.ctypes.data_as(_pi32), n_threads,
        _FMT[payload], _CODEC[codec])
    if ret < 0:
        raise IOError(f"native unpack failed at item {-(ret + 1)}")
    return shapes


# ---- bundle-mode variants: encode to blobs / unpack from memory ----

_pu8 = ctypes.POINTER(ctypes.c_uint8)


def _collect_blobs(n, blob_ptrs, sizes, ret):
    """Copy the native-allocated blobs into Python bytes and free them
    (including on a failed call, where earlier items may own memory)."""
    try:
        if ret < 0:
            raise IOError(f"native encode failed at item {-(ret + 1)}")
        return [ctypes.string_at(blob_ptrs[i], sizes[i]) for i in range(n)]
    finally:
        for i in range(n):
            if blob_ptrs[i]:
                lib.wtc_free_blob(blob_ptrs[i])


def encode_strided(coeffs: np.ndarray, t32: np.ndarray, shape,
                   rows: int, row_len: int, row_stride: int,
                   offsets: np.ndarray, n_threads: int = 0,
                   payload: str = "f32", codec: str = "xz",
                   preset: int = 6) -> list:
    """Like :func:`pack_strided` but returns each item's encoded container
    bytes (bundle mode) instead of writing per-item files."""
    coeffs = np.ascontiguousarray(coeffs, dtype=np.float32)
    t32 = np.ascontiguousarray(t32, dtype=np.float32)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    _check_total(shape)
    shp = np.asarray(shape, dtype=np.int32)
    n = len(offsets)
    blob_ptrs = (_pu8 * n)()
    sizes = np.zeros(n, dtype=np.int64)
    ret = lib.wtc_encode_strided(
        coeffs.ctypes.data_as(_pf), t32.ctypes.data_as(_pf),
        n, rows, row_len, row_stride,
        offsets.ctypes.data_as(_pi64), shp.ctypes.data_as(_pi32),
        blob_ptrs, sizes.ctypes.data_as(_pi64), n_threads, _FMT[payload],
        _CODEC[codec], int(preset))
    return _collect_blobs(n, blob_ptrs, sizes, ret)


def encode_indexed(coeffs: np.ndarray, t32: np.ndarray, shape,
                   ix: np.ndarray, iy: np.ndarray, iz: np.ndarray,
                   offsets: np.ndarray, n_threads: int = 0,
                   payload: str = "f32", codec: str = "xz",
                   preset: int = 6) -> list:
    """Blob-returning variant of :func:`pack_indexed` (bundle mode)."""
    coeffs = np.ascontiguousarray(coeffs, dtype=np.float32)
    t32 = np.ascontiguousarray(t32, dtype=np.float32)
    ix = np.ascontiguousarray(ix, dtype=np.int64)
    iy = np.ascontiguousarray(iy, dtype=np.int64)
    iz = np.ascontiguousarray(iz, dtype=np.int64)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    _check_total(shape)
    shp = np.asarray(shape, dtype=np.int32)
    n = len(offsets)
    blob_ptrs = (_pu8 * n)()
    sizes = np.zeros(n, dtype=np.int64)
    ret = lib.wtc_encode_indexed(
        coeffs.ctypes.data_as(_pf), t32.ctypes.data_as(_pf),
        n, len(ix), len(iy), len(iz),
        ix.ctypes.data_as(_pi64), iy.ctypes.data_as(_pi64),
        iz.ctypes.data_as(_pi64), offsets.ctypes.data_as(_pi64),
        shp.ctypes.data_as(_pi32), blob_ptrs,
        sizes.ctypes.data_as(_pi64), n_threads, _FMT[payload],
        _CODEC[codec], int(preset))
    return _collect_blobs(n, blob_ptrs, sizes, ret)


def encode_mapped(coeffs: np.ndarray, t32: np.ndarray, shape,
                  coeff_map: np.ndarray, offsets: np.ndarray,
                  n_threads: int = 0, payload: str = "f32",
                  codec: str = "xz", preset: int = 6) -> list:
    """Blob-returning variant of :func:`pack_mapped` (bundle mode)."""
    coeffs = np.ascontiguousarray(coeffs, dtype=np.float32)
    t32 = np.ascontiguousarray(t32, dtype=np.float32)
    coeff_map = np.ascontiguousarray(coeff_map, dtype=np.int64)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    _check_total(shape)
    shp = np.asarray(shape, dtype=np.int32)
    n = len(offsets)
    blob_ptrs = (_pu8 * n)()
    sizes = np.zeros(n, dtype=np.int64)
    ret = lib.wtc_encode_mapped(
        coeffs.ctypes.data_as(_pf), t32.ctypes.data_as(_pf),
        n, len(coeff_map),
        coeff_map.ctypes.data_as(_pi64), offsets.ctypes.data_as(_pi64),
        shp.ctypes.data_as(_pi32), blob_ptrs,
        sizes.ctypes.data_as(_pi64), n_threads, _FMT[payload],
        _CODEC[codec], int(preset))
    return _collect_blobs(n, blob_ptrs, sizes, ret)


def _blob_arrays(blobs):
    """(pointer array, size array) viewing a list of bytes objects —
    zero-copy: the pointers alias the bytes' buffers, valid while the list
    is alive (callers keep it alive across the native call)."""
    n = len(blobs)
    ptrs = (_pu8 * n)()
    sizes = np.empty(n, dtype=np.int64)
    for i, b in enumerate(blobs):
        ptrs[i] = ctypes.cast(ctypes.c_char_p(b), _pu8)
        sizes[i] = len(b)
    return ptrs, sizes


def unpack_strided_mem(blobs, dest: np.ndarray, rows: int, row_len: int,
                       row_stride: int, offsets: np.ndarray,
                       n_threads: int = 0, payload: str = "f32",
                       codec: str = "xz") -> np.ndarray:
    """Memory-source variant of :func:`unpack_strided`: ``blobs`` is a list
    of per-item container bytes (bundle members)."""
    assert dest.dtype == np.float32 and dest.flags.c_contiguous
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    n = len(blobs)
    ptrs, sizes = _blob_arrays(blobs)
    shapes = np.empty((n, 3), dtype=np.int32)
    ret = lib.wtc_unpack_strided_mem(
        ptrs, sizes.ctypes.data_as(_pi64), n, rows, row_len, row_stride,
        offsets.ctypes.data_as(_pi64), dest.ctypes.data_as(_pf),
        shapes.ctypes.data_as(_pi32), n_threads, _FMT[payload],
        _CODEC[codec])
    if ret < 0:
        raise IOError(f"native unpack failed at item {-(ret + 1)}")
    return shapes


def unpack_indexed_mem(blobs, dest: np.ndarray, ix: np.ndarray,
                       iy: np.ndarray, iz: np.ndarray, offsets: np.ndarray,
                       n_threads: int = 0, payload: str = "f32",
                       codec: str = "xz") -> np.ndarray:
    """Memory-source variant of :func:`unpack_indexed` (bundle mode)."""
    assert dest.dtype == np.float32 and dest.flags.c_contiguous
    ix = np.ascontiguousarray(ix, dtype=np.int64)
    iy = np.ascontiguousarray(iy, dtype=np.int64)
    iz = np.ascontiguousarray(iz, dtype=np.int64)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    n = len(blobs)
    ptrs, sizes = _blob_arrays(blobs)
    shapes = np.empty((n, 3), dtype=np.int32)
    ret = lib.wtc_unpack_indexed_mem(
        ptrs, sizes.ctypes.data_as(_pi64), n, len(ix), len(iy), len(iz),
        ix.ctypes.data_as(_pi64), iy.ctypes.data_as(_pi64),
        iz.ctypes.data_as(_pi64), offsets.ctypes.data_as(_pi64),
        dest.ctypes.data_as(_pf), shapes.ctypes.data_as(_pi32), n_threads,
        _FMT[payload], _CODEC[codec])
    if ret < 0:
        raise IOError(f"native unpack failed at item {-(ret + 1)}")
    return shapes


def unpack_mapped_mem(blobs, dest: np.ndarray, coeff_map: np.ndarray,
                      offsets: np.ndarray, n_threads: int = 0,
                      payload: str = "f32", codec: str = "xz") -> np.ndarray:
    """Memory-source variant of :func:`unpack_mapped` (bundle mode)."""
    assert dest.dtype == np.float32 and dest.flags.c_contiguous
    coeff_map = np.ascontiguousarray(coeff_map, dtype=np.int64)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    n = len(blobs)
    ptrs, sizes = _blob_arrays(blobs)
    shapes = np.empty((n, 3), dtype=np.int32)
    ret = lib.wtc_unpack_mapped_mem(
        ptrs, sizes.ctypes.data_as(_pi64), n, len(coeff_map),
        coeff_map.ctypes.data_as(_pi64), offsets.ctypes.data_as(_pi64),
        dest.ctypes.data_as(_pf), shapes.ctypes.data_as(_pi32), n_threads,
        _FMT[payload], _CODEC[codec])
    if ret < 0:
        raise IOError(f"native unpack failed at item {-(ret + 1)}")
    return shapes


def fab_from_boxes(arr: np.ndarray, dtype, n_threads: int = 0) -> np.ndarray:
    """(C, X, Y, Z) f32 box -> on-disk FAB order (C, Z, Y, X) in ``dtype``
    (f64 or f32), via the cache-blocked native transpose (6-14x NumPy's
    strided axis-reversal copy — bench_results/plotfile_io.json)."""
    assert arr.dtype == np.float32 and arr.flags.c_contiguous
    ncomp, x, y, z = arr.shape
    dtype = np.dtype(dtype)
    if dtype not in (np.dtype(np.float32), np.dtype(np.float64)):
        # any other dtype would allocate a smaller output than the
        # native f32/f64 writer fills — heap corruption, not an error
        raise ValueError(f"fab dtype must be float32/float64, got {dtype}")
    out = np.empty((ncomp, z, y, x), dtype=dtype)
    ret = lib.wtc_fab_from_boxes(
        arr.ctypes.data_as(_pf), ncomp, x, y, z,
        out.ctypes.data_as(ctypes.c_void_p),
        1 if dtype == np.float64 else 0, n_threads)
    if ret < 0:
        raise RuntimeError("native fab transpose failed")
    return out


def boxes_from_fab(fab: np.ndarray, x: int, y: int, z: int,
                   n_threads: int = 0) -> np.ndarray:
    """On-disk FAB order (C, Z, Y, X) f64/f32 -> (C, X, Y, Z) f32 box
    (reader direction of :func:`fab_from_boxes`)."""
    assert fab.flags.c_contiguous and fab.dtype in (np.float32, np.float64)
    ncomp = fab.shape[0]
    if fab.size != ncomp * x * y * z:
        # the dims are caller-supplied (the FAB header's box extents); a
        # mismatch with the actual buffer would read out of bounds in
        # native code with no error
        raise ValueError(
            f"FAB buffer holds {fab.size} elements but dims imply "
            f"{ncomp}x{x}x{y}x{z} = {ncomp * x * y * z}")
    out = np.empty((ncomp, x, y, z), dtype=np.float32)
    ret = lib.wtc_boxes_from_fab(
        fab.ctypes.data_as(ctypes.c_void_p),
        1 if fab.dtype == np.float64 else 0, ncomp, x, y, z,
        out.ctypes.data_as(_pf), n_threads)
    if ret < 0:
        raise RuntimeError("native fab transpose failed")
    return out
