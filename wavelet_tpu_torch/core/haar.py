"""Batched single-scale 3D Haar (Daubechies-1) transform in PyTorch.

The plain reference the CUDA kernels (kernels/haar_cuda.py) are held to,
and the path a CPU tensor takes.  Semantics are those of
``wavelet_tpu.core.haar`` and of the C++ reference
(``compressor.cpp:85-185`` forward, ``decompressor.cpp:79-159`` inverse):

- forward: along Z, then Y, then X, each 1D line of length n maps pairs
  ``(a, b) -> low=(a+b)*0.5`` into ``[0, n//2)`` and ``high=(a-b)*0.5``
  into ``[n//2, 2*(n//2))``; an odd trailing element passes through.
- inverse: along X, then Y, then Z: ``out[2i] = avg+diff``,
  ``out[2i+1] = avg-diff``; an odd trailing slot is zeroed
  (decompressor.cpp:99-108).

Each output is rounded to float32 exactly once: ``fl(a+b)`` is exact
whenever ``|a+b| < 2**-125`` and the halving is exact above that, so
``fl(fl(a+b)*0.5)`` equals the reference's double-precision
``(a+b)/2.0`` rounded once — subnormals included, as long as the
arithmetic does not flush them (PyTorch keeps subnormals unless
``torch.set_flush_denormal(True)``; JAX's CPU backend flushes them).

Tensors are ``[..., X, Y, Z]``; the C-order flatten of the trailing three
axes is the reference's coefficient order (``compressor.cpp:178-181``).
"""

from __future__ import annotations

import torch

__all__ = ["haar3d_forward", "haar3d_inverse", "forward_flat",
           "inverse_from_flat"]


def _fwd_last(x: torch.Tensor) -> torch.Tensor:
    """One forward Haar pass along the last axis."""
    n = x.shape[-1]
    h = n // 2
    v = x[..., : 2 * h].reshape(x.shape[:-1] + (h, 2))
    a = v[..., 0]
    b = v[..., 1]
    parts = [(a + b) * 0.5, (a - b) * 0.5]
    if n % 2:
        parts.append(x[..., 2 * h:])
    return torch.cat(parts, dim=-1)


def _inv_last(c: torch.Tensor) -> torch.Tensor:
    """One inverse Haar pass along the last axis (odd trailing slot zeroed)."""
    n = c.shape[-1]
    h = n // 2
    avg = c[..., :h]
    diff = c[..., h: 2 * h]
    out = torch.stack([avg + diff, avg - diff], dim=-1).reshape(
        c.shape[:-1] + (2 * h,))
    if n % 2:
        out = torch.cat([out, torch.zeros_like(c[..., :1])], dim=-1)
    return out


def _along(fn, x: torch.Tensor, axis: int) -> torch.Tensor:
    if axis in (-1, x.dim() - 1):
        return fn(x)
    return fn(x.movedim(axis, -1)).movedim(-1, axis)


def haar3d_forward(x: torch.Tensor) -> torch.Tensor:
    """Forward transform of ``[..., X, Y, Z]``: Z pass, Y pass, X pass."""
    x = _along(_fwd_last, x, -1)   # Z  (compressor.cpp:98-125)
    x = _along(_fwd_last, x, -2)   # Y  (compressor.cpp:128-150)
    x = _along(_fwd_last, x, -3)   # X  (compressor.cpp:153-175)
    return x.contiguous()


def haar3d_inverse(c: torch.Tensor) -> torch.Tensor:
    """Inverse transform of ``[..., X, Y, Z]``: X pass, Y pass, Z pass."""
    c = _along(_inv_last, c, -3)   # X  (decompressor.cpp:90-114)
    c = _along(_inv_last, c, -2)   # Y  (decompressor.cpp:117-135)
    c = _along(_inv_last, c, -1)   # Z  (decompressor.cpp:138-156)
    return c.contiguous()


def forward_flat(x: torch.Tensor) -> torch.Tensor:
    """Forward transform + C-order flatten of the trailing 3 axes."""
    c = haar3d_forward(x)
    return c.reshape(c.shape[:-3] + (-1,))


def inverse_from_flat(flat: torch.Tensor, dims) -> torch.Tensor:
    """Inverse transform from flat coefficients; ``dims`` = (X, Y, Z)."""
    return haar3d_inverse(flat.reshape(flat.shape[:-1] + tuple(dims)))
