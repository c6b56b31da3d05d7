"""Per-box coefficient thresholding with exact reference parity.

Reference rule (``compressor.cpp:212-234``), per (box, component):

    max_val = the *signed* coefficient whose |value| is largest (first on ties)
    thresh  = max_val * (1 - keep)          # in double
    keep c  iff |c| > thresh                # |c| widened to double

Counterpart of ``wavelet_tpu.core.threshold`` (``signed_absmax`` and
``exact_threshold32``) for the port, which cannot import that module: it
imports jax at the top.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["signed_absmax", "exact_threshold32"]


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
