"""Per-box coefficient thresholding with exact reference parity.

Reference rule (``compressor.cpp:212-234``), per (box, component):

    max_val = the *signed* coefficient whose |value| is largest (first on ties)
    thresh  = max_val * (1 - keep)          # in double
    keep c  iff |c| > thresh                # |c| widened to double

The *global* mode (an extension) instead keeps about ``keep_fraction`` of
all the run's coefficients: one magnitude threshold from a fixed-bin
histogram of float bits that merges by addition across batches.

Counterpart of ``wavelet_tpu.core.threshold`` (``signed_absmax``,
``exact_threshold32``, ``abs_exponent_histogram``,
``threshold_from_histogram``) for the port, which cannot import that
module: it imports jax at the top.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["signed_absmax", "exact_threshold32", "EXP_HIST_BINS",
           "abs_exponent_histogram", "threshold_from_histogram"]


def signed_absmax(coeffs: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Signed value of the largest-|.| element along ``dim`` (first on ties).

    Matches ``std::max_element`` with an |a|<|b| comparator
    (compressor.cpp:212-215): the earliest maximum wins.  ``torch.argmax``
    returns the first occurrence, as ``jnp.argmax`` does, and both treat a
    NaN as the maximum.
    """
    idx = torch.argmax(coeffs.abs(), dim=dim, keepdim=True)
    return torch.take_along_dim(coeffs, idx, dim=dim).squeeze(dim)


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
