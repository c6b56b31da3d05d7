"""Per-box coefficient thresholding with exact reference parity.

Reference rule (``compressor.cpp:212-234``), per (box, component):

    max_val = the *signed* coefficient whose |value| is largest (first on ties)
    thresh  = max_val * (1 - keep)          # in double
    keep c  iff |c| > thresh                # |c| widened to double

The *global* mode (an extension) instead keeps about ``keep_fraction`` of
all the run's coefficients: one magnitude threshold from a fixed-bin
histogram of float bits that merges by addition across batches.

Counterpart of ``wavelet_tpu.core.threshold`` (``signed_absmax``,
``exact_threshold32``, ``mask_coefficients``, ``abs_exponent_histogram``,
``threshold_from_histogram``, ``threshold_from_histogram_device``,
``global_histogram_threshold``) for the port, which cannot import that
module: it imports jax at the top.  ``resolve_signed_absmax`` is the JAX
engine's helper of that name (``wavelet_tpu/runtime/engine.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["signed_absmax", "resolve_signed_absmax", "exact_threshold32",
           "mask_coefficients", "EXP_HIST_BINS", "abs_exponent_histogram",
           "threshold_from_histogram", "threshold_from_histogram_device",
           "global_histogram_threshold"]


def signed_absmax(coeffs: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Signed value of the largest-|.| element along ``dim`` (first on ties).

    Matches ``std::max_element`` with an |a|<|b| comparator
    (compressor.cpp:212-215): the earliest maximum wins.  ``torch.argmax``
    returns the first occurrence, as ``jnp.argmax`` does, and both treat a
    NaN as the maximum.
    """
    idx = torch.argmax(coeffs.abs(), dim=dim, keepdim=True)
    return torch.take_along_dim(coeffs, idx, dim=dim).squeeze(dim)


def resolve_signed_absmax(maxv: np.ndarray, minv: np.ndarray,
                          row_getter=None) -> np.ndarray:
    """Signed largest-|.| value from per-box (max, min) pairs.

    The signed extremum is whichever has the larger magnitude.  The only
    ambiguous case is an exact tie ``min == -max != 0``, where the reference
    picks whichever occurs *first* in flatten order (compressor.cpp:212-215);
    those rare boxes are resolved from ``row_getter(i)``, which must return
    item i's flat coefficients on the host.
    """
    signed = np.where(np.abs(maxv) >= np.abs(minv), maxv, minv)
    tie = (minv == -maxv) & (maxv != 0)
    if tie.any() and row_getter is not None:
        for i in np.flatnonzero(tie):
            row = np.asarray(row_getter(int(i)))
            signed[i] = row[np.argmax(np.abs(row))]
    return signed


def exact_threshold32(max_vals: np.ndarray, keep: float) -> np.ndarray:
    """float32 thresholds reproducing the double comparison exactly.

    ``thresh64 = f64(max_val) * (1 - keep)`` as the reference computes it;
    returns the largest float32 <= thresh64, so that a float32 magnitude
    compares ``> t32`` exactly when it compares ``> thresh64``.
    """
    thresh64 = np.asarray(max_vals).astype(np.float64) * (1.0 - float(keep))
    t32 = thresh64.astype(np.float32)
    too_high = t32.astype(np.float64) > thresh64
    t32 = np.where(too_high, np.nextafter(t32, np.float32(-np.inf)), t32)
    return np.asarray(t32, dtype=np.float32)


def mask_coefficients(coeffs: torch.Tensor,
                      t32: torch.Tensor) -> torch.Tensor:
    """Boolean keep-mask: ``|c| > t32`` broadcast over the trailing
    axis."""
    return coeffs.abs() > t32[..., None]


# 11-bit keys: sign-stripped float32 bits >> 20 = 8 exponent bits + 3
# mantissa bits, monotone in |c| (the top key is 0x7FF = 2047).
EXP_HIST_BINS = 2048
_EXP_SHIFT = 20


def abs_exponent_histogram(coeffs: torch.Tensor) -> torch.Tensor:
    """int64[EXP_HIST_BINS] histogram of ``|coeffs|`` by float bits: key
    ``(bits & 0x7FFFFFFF) >> 20``.  Bin edges are fixed by the float32
    format, so histograms of different batches merge by addition.  -0.0
    falls in bin 0, +-inf in bin 2040, a NaN by its payload (a sign-set
    quiet NaN in 2044, as ``jnp.abs`` clears the sign)."""
    bits = coeffs.reshape(-1).view(torch.int32) & 0x7FFFFFFF
    return torch.bincount(bits >> _EXP_SHIFT, minlength=EXP_HIST_BINS)


def threshold_from_histogram(hist: np.ndarray,
                             keep_fraction: float) -> np.float32:
    """Magnitude threshold keeping ~``keep_fraction`` of all coefficients.

    Picks the smallest bin edge such that the count of strictly-greater bins
    is <= target; coefficients compare ``|c| > thresh``.
    """
    hist = np.asarray(hist, dtype=np.int64)
    total = int(hist.sum())
    target = keep_fraction * total
    above = np.cumsum(hist[::-1])[::-1]  # above[k] = count of bins >= k
    # smallest k with above[k] <= target -> keep bins >= k
    ks = np.nonzero(above <= target)[0]
    k = int(ks[0]) if len(ks) else EXP_HIST_BINS
    # a target inside a populated bin with nothing above it would keep
    # nothing (a constant box puts every coefficient in one bin): step down
    # to the last populated bin and overshoot the target instead
    while k > 1 and (k >= len(above) or above[k] == 0):
        k -= 1
    if k <= 1:
        return np.float32(0.0)
    # |c| > thresh must hold exactly for bins >= k: thresh is the largest
    # float below bin k's lower edge, i.e. bits (k << shift) - 1
    prev = np.uint32((k << _EXP_SHIFT) - 1)
    return prev.view(np.float32)


def threshold_from_histogram_device(hist: torch.Tensor, keep_fraction: float,
                                    total, pad_zeros: int = 0,
                                    group=None) -> torch.Tensor:
    """:func:`threshold_from_histogram` in torch on ``hist``'s device: a
    0-d float32 tensor there, bin for bin the host's threshold.

    ``hist`` is an int64 (or any integer) histogram of
    :data:`EXP_HIST_BINS` bins; with a process ``group`` it is first
    summed over the group (one gloo ``all_reduce`` of int64 host counts,
    which every process of the group must launch).  ``pad_zeros`` zero
    coefficients of padding rows come out of bin 0 after the sum, as the
    host pipeline subtracts them.  ``total`` is the number of real
    coefficients (a Python number, the histogram's sum after the
    correction).

    The counts stay int64 through the cumulative sum, and the target is
    the integer ``floor(keep_fraction * total)`` taken in Python f64:
    ``count <= floor(t)`` is exactly the host's ``count <= t`` for integer
    counts.  So the selection is exact at every size; the JAX package's
    float32 cumulative sum is exact only below 2**24 coefficients."""
    h = hist.to(torch.int64)
    if group is not None:
        import torch.distributed as dist

        host = h.cpu()
        dist.all_reduce(host, op=dist.ReduceOp.SUM, group=group)
        h = host.to(hist.device)
    if pad_zeros:
        h = h.clone()
        h[0] -= int(pad_zeros)
    above = torch.flip(torch.cumsum(torch.flip(h, [0]), 0), [0])
    target = math.floor(float(keep_fraction) * float(total))
    le = above <= target
    # host: the smallest k with above[k] <= target, else EXP_HIST_BINS;
    # then step down while bins >= k hold nothing, i.e. clamp to the last
    # index with above > 0 (above does not increase)
    k0 = torch.where(le.any(), torch.argmax(le.to(torch.int32)),
                     torch.tensor(EXP_HIST_BINS, device=h.device))
    kmax = (above > 0).sum() - 1
    k = torch.minimum(k0, kmax).to(torch.int32)
    thr = ((k << _EXP_SHIFT) - 1).view(torch.float32)
    return torch.where(k <= 1, torch.zeros((), device=h.device), thr)


def global_histogram_threshold(coeffs, keep_fraction: float,
                               n_pad_coeffs: int = 0,
                               mesh=None) -> torch.Tensor:
    """The magnitude threshold keeping about ``keep_fraction`` of every
    coefficient of ``coeffs`` (a tensor, or this process's per-entry
    chunks of a batch over ``mesh``): their summed fixed-bin histogram
    through :func:`threshold_from_histogram_device`, on the first chunk's
    device.  Over a ``mesh`` that spans processes, the histogram sums over
    the process group too and the total counts every process's equal
    share.  ``n_pad_coeffs`` zero coefficients of padding rows leave both
    the histogram's bin 0 and the total, as in the host pipeline."""
    chunks = list(coeffs) if isinstance(coeffs, (list, tuple)) else [coeffs]
    dev = chunks[0].device
    hist = sum(abs_exponent_histogram(c).to(dev) for c in chunks)
    total = sum(c.numel() for c in chunks)
    group = None
    if mesh is not None and mesh.spans_processes:
        import torch.distributed as dist

        total *= mesh.n_procs
        group = dist.group.WORLD
    return threshold_from_histogram_device(hist, keep_fraction,
                                           total - int(n_pad_coeffs),
                                           pad_zeros=n_pad_coeffs,
                                           group=group)
