"""Giant boxes split along X over a device mesh, with zero collectives:
the port's counterpart of ``make_sharded_box_forward_interleaved`` and
``make_sharded_box_inverse_interleaved``
(``wavelet_tpu/runtime/distributed.py:190-241``).

A box too large for one device's working set is cut into ``D =
mesh.size`` X-slabs ``[X/D, Y, Z]``, one per mesh entry.  Every Haar pair
along X at every scale stays inside one slab when ``X/D`` divides by
``2**scales`` (``CodecEngine.giant_ok``), so each entry runs the ordinary
kernels on its slab — ``haar_cuda.fused_forward`` (K1) or
``pyramid_cuda.pyramid_forward`` (K5), ``pyramid_cuda.forward_hist`` (K6)
for the global pass, ``fused_inverse`` (K2) or ``pyramid_inverse`` (K7) —
and no data crosses between slabs.

The JAX package gets a layout that needs no regroup from its interleaved
coefficients; the port keeps the halves layout, so the host regroups the
X rows of the D slab pyramids into the whole box's pyramid
(:func:`assemble`) and back (:func:`split`).  Scale s of a slab writes its
X low half over rows ``[0, xs/2)`` and its high half over ``[xs/2, xs)``
of its current corner, so the whole box's corner at scale s takes slab
k's low rows at ``k*xs/2`` and its high rows at ``cx/2 + k*xs/2``; that
regroup applies to the whole current corner ``[cx, cy, cz]`` (the Y and Z
passes never mix slabs), and the next scale repeats it inside the LLL
corner with ``cx/2`` and ``xs/2``.  The regroup only moves values, so the
assembled pyramid is bitwise the whole-box ``haar3d_forward_multi``.
"""

from __future__ import annotations

import numpy as np
import torch

from wavelet_tpu_torch.core import threshold
from wavelet_tpu_torch.kernels import haar_cuda, pyramid_cuda

__all__ = ["slab_row_map", "assemble", "split", "sharded_box_forward",
           "sharded_box_forward_hist", "sharded_box_inverse"]


def slab_row_map(cx: int, d: int) -> np.ndarray:
    """Rows of one scale's regroup: the whole box's row j of a ``cx``-row
    corner comes from row ``src[j]`` of the D slabs' corners stacked along
    X (each ``cx/d`` rows)."""
    xs = cx // d
    h = xs // 2
    base = (np.arange(d) * xs)[:, None] + np.arange(h)[None, :]
    return np.concatenate([base.reshape(-1), (base + h).reshape(-1)])


def _corners(shape, scales: int):
    x, y, z = shape
    return [(x >> s, y >> s, z >> s) for s in range(scales)]


def assemble(slabs: np.ndarray, scales: int) -> np.ndarray:
    """``[D, X/D, Y, Z]`` slab pyramids -> the ``[X, Y, Z]`` box pyramid."""
    d, xs, y, z = slabs.shape
    out = np.ascontiguousarray(slabs.reshape(d * xs, y, z))
    for cx, cy, cz in _corners(out.shape, scales):
        out[:cx, :cy, :cz] = out[slab_row_map(cx, d), :cy, :cz]
    return out


def split(coeffs: np.ndarray, d: int, scales: int) -> np.ndarray:
    """Inverse of :func:`assemble`: ``[X, Y, Z]`` -> ``[D, X/D, Y, Z]``."""
    x, y, z = coeffs.shape
    out = np.array(coeffs, dtype=np.float32, copy=True)
    for cx, cy, cz in reversed(_corners(out.shape, scales)):
        out[slab_row_map(cx, d), :cy, :cz] = out[:cx, :cy, :cz].copy()
    return out.reshape(d, x // d, y, z)


def _slabs_on_mesh(mesh, slabs: np.ndarray):
    """``[D, X/D, Y, Z]`` -> slab k as ``[1, X/D, Y, Z]`` on entry k."""
    return [torch.from_numpy(np.ascontiguousarray(
                slabs[k], np.float32)[None]).to(dev)
            for k, dev in enumerate(mesh.devices)]


def _as_slabs(mesh, box: np.ndarray) -> np.ndarray:
    """``[X, Y, Z]`` -> ``[D, X/D, Y, Z]``, a view of the box."""
    return box.reshape(mesh.size, -1, *box.shape[1:])


def sharded_box_forward(mesh, box: np.ndarray, scales: int):
    """One giant box ``[X, Y, Z]`` -> (its pyramid ``[X, Y, Z]``, max,
    min): each slab through K1 (scales 1) or K5 on its mesh entry; the
    extrema are the NaN-propagating max/min over the slabs'."""
    outs = [haar_cuda.fused_forward(s) if scales == 1
            else pyramid_cuda.pyramid_forward(s, scales)
            for s in _slabs_on_mesh(mesh, _as_slabs(mesh, box))]
    coeffs = assemble(np.concatenate([c.cpu().numpy() for c, _, _ in outs]),
                      scales)
    maxv = np.max([float(mx.cpu()[0]) for _, mx, _ in outs]).astype(
        np.float32)
    minv = np.min([float(mn.cpu()[0]) for _, _, mn in outs]).astype(
        np.float32)
    return coeffs, maxv, minv


def sharded_box_forward_hist(mesh, box: np.ndarray, scales: int,
                             fetch_coeffs: bool = True):
    """One giant box -> (its pyramid or None, int64 magnitude histogram):
    each slab through K6 on its mesh entry.  The box's histogram is the
    sum of the slabs' (the same coefficients, counted once each); the
    kernel counts with 64-bit atomics, so no slab needs the 2**31-element
    segmenting the JAX package's 32-bit device histogram does."""
    outs = [pyramid_cuda.forward_hist(s, scales)
            for s in _slabs_on_mesh(mesh, _as_slabs(mesh, box))]
    hist = np.zeros(threshold.EXP_HIST_BINS, np.int64)
    for _, h in outs:
        hist += h.cpu().numpy()
    if not fetch_coeffs:
        return None, hist
    return assemble(np.concatenate([c.cpu().numpy() for c, _ in outs]),
                    scales), hist


def sharded_box_inverse(mesh, coeffs: np.ndarray, scales: int) -> np.ndarray:
    """Inverse of :func:`sharded_box_forward`: the box pyramid split into
    slab pyramids, each through K2 (scales 1) or K7 on its mesh entry,
    the slabs concatenated along X."""
    outs = [haar_cuda.fused_inverse(s) if scales == 1
            else pyramid_cuda.pyramid_inverse(s, scales)
            for s in _slabs_on_mesh(mesh, split(coeffs, mesh.size, scales))]
    return np.concatenate([o.cpu().numpy()[0] for o in outs])
