"""Loss and size metrics (reference: ``calc-loss.cpp``, ``modes.cpp:269-324``).

The port's own copy of ``wavelet_tpu/core/metrics.py``, unchanged, so that
the port imports nothing of ``wavelet_tpu``.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["rmse_per_box", "adjusted_loss", "dir_size", "mean_rmse"]


def rmse_per_box(actual: np.ndarray, pred: np.ndarray) -> np.ndarray:
    """Per-component RMSE of one box pair, double accumulation.

    ``actual``/``pred`` are ``(C, X, Y, Z)``; matches calc-loss.cpp:12-43
    (sum of squared diffs in double / number of cells, sqrt).
    """
    diff = actual.astype(np.float64) - pred.astype(np.float64)
    c = diff.shape[0]
    return np.sqrt(np.mean(diff.reshape(c, -1) ** 2, axis=1))


def mean_rmse(per_box_rmses) -> np.ndarray:
    """Unweighted mean over boxes, per component — the reference's estimator
    (modes.cpp:283-285): boxes of different sizes contribute equally."""
    return np.mean(np.asarray(per_box_rmses, dtype=np.float64), axis=0)


def adjusted_loss(rmse, value_range) -> float:
    """RMSE / data range (calc-loss.cpp:49-51)."""
    return np.asarray(rmse, dtype=np.float64) / np.asarray(value_range, np.float64)


def dir_size(path: str) -> int:
    """Recursive byte size of a directory (calc-loss.cpp:55-65)."""
    total = 0
    for root, _dirs, names in os.walk(path):
        for n in names:
            total += os.path.getsize(os.path.join(root, n))
    return total
