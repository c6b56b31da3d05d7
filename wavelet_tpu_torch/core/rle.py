"""Vectorized run-length coding of thresholded coefficients (host side).

The port's own copy of ``wavelet_tpu/core/rle.py``,
unchanged but for its imports, so that the port imports nothing of
``wavelet_tpu``.

Format identical to the reference (``compressor.cpp:24-42`` encode,
``decompressor.cpp:14-30`` decode): a sequence of pairs
``(zeros_before, value)`` covering the kept coefficients in flatten order;
trailing zeros after the last kept value are implicit (the total coefficient
count travels in the payload header).

The reference loops element-by-element; here both directions are O(n) NumPy
vector ops (``flatnonzero``/``diff`` for encode, ``cumsum`` scatter for
decode), which is what keeps the host pack stage off the critical path of
the TPU pipeline.
"""

from __future__ import annotations

import numpy as np

__all__ = ["rle_encode_mask", "rle_encode_pairs", "rle_decode",
           "rle_decode_pairs"]


def rle_encode_mask(mask: np.ndarray, values_src: np.ndarray):
    """Encode: ``mask`` (bool[n]) selects kept entries of ``values_src`` (f32[n]).

    Returns ``(runs int32[k], vals float32[k])`` — runs of zeros before each
    kept value, exactly the pair stream of compressor.cpp:24-42.
    """
    idx = np.flatnonzero(mask)
    return rle_encode_pairs(idx), \
        values_src[idx].astype(np.float32, copy=False)


def rle_encode_pairs(idx: np.ndarray) -> np.ndarray:
    """Sorted kept POSITIONS -> runs of zeros before each kept value —
    the sparse transport's encode direction (engine.HostPacker.pack_
    sparse), kept here beside :func:`rle_decode_pairs` so the dense and
    sparse paths share one definition of the run convention and can
    never drift apart."""
    return (np.diff(idx, prepend=np.int64(-1)) - 1).astype(np.int32)


def rle_decode(runs: np.ndarray, vals: np.ndarray, total: int) -> np.ndarray:
    """Decode to a zero-padded float32[total] coefficient vector.

    Well-formed payloads take the vectorized path: positions are
    ``cumsum(runs + 1) - 1``.  Malformed payloads (an out-of-range or
    negative position anywhere) fall back to a scalar loop reproducing the
    reference's exact semantics (decompressor.cpp:14-30): ``idx += run``,
    and a pair only writes *and only advances the extra +1* when ``idx`` is
    in range — identical to the C++ codec (native/wtc_codec.cpp
    wtc_unpack_strided), so both reconstruct the same data from the same
    corrupt input.  (The lower-bound check is a hardening the reference
    lacks; negative ``idx`` is UB in its case.)
    """
    out = np.zeros(total, dtype=np.float32)
    if len(runs) == 0:
        return out
    runs = np.asarray(runs)
    if runs.min() >= 0:
        pos = np.cumsum(runs.astype(np.int64) + 1) - 1
        if pos[-1] < total:  # monotone since runs >= 0, so all in range
            out[pos] = vals
            return out
    idx = 0
    for run, val in zip(runs, vals):
        idx += int(run)
        if 0 <= idx < total:
            out[idx] = val
            idx += 1
    return out


def rle_decode_pairs(runs: np.ndarray, vals: np.ndarray, total: int):
    """Decode to ``(positions int64[k], values f32[k])`` without
    materializing the dense vector (sparse-transfer decompress).

    Same two paths and the SAME malformed-stream semantics as
    :func:`rle_decode` — this helper is the single home of that contract,
    so the sparse and dense transports can never drift apart on corrupt
    payloads.
    """
    runs = np.asarray(runs)
    if len(runs):
        if runs.min() >= 0:
            pos = np.cumsum(runs.astype(np.int64) + 1) - 1
            if pos[-1] < total:
                return pos, np.asarray(vals)
        row = rle_decode(runs, vals, total)
        pos = np.flatnonzero(row)
        return pos, row[pos]
    return np.zeros(0, np.int64), np.zeros(0, np.float32)
