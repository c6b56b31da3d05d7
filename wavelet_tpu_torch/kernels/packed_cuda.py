"""Lane-packed single-scale Haar kernels for Hopper: wrappers, plain
versions and launch counts.

A packed batch is ``[M, X, Y, P*Z]`` f32: row m holds P boxes, box p's
Z-axis at lanes ``[p*Z, (p+1)*Z)`` (``runtime/batching.ShapeBatch`` with
``pack = P``); item ``m*P + p`` is that box.

- :func:`packed_forward` ``-> (coeffs [M, X, Y, P*Z], max [M*P], min
  [M*P])`` replaces ``wavelet_tpu/kernels/haar_pallas.py:
  _fused_forward_packed_call``;
- :func:`packed_inverse` replaces ``haar_pallas.py:
  _fused_inverse_packed_call``;
- :func:`packed_forward_hist` ``-> (coeffs, int64 [2048])`` is
  ``_fused_forward_packed_call`` followed by ``abs_exponent_histogram``,
  the packed global-threshold pass of the JAX engine, without the extrema.

Coefficients stay packed, each box in the halves (logical) order of
:mod:`wavelet_tpu_torch.core.haar`; extrema are in item order.  The kernels
are CUDA C++ (``wavelet_tpu_torch/csrc/packed.cu``), built by
:mod:`wavelet_tpu_torch.kernels.build`.  A CUDA tensor launches the kernel
or raises; a CPU tensor goes to the plain PyTorch version below, which is
also what the kernels are held to on the card.  ``launches`` counts kernel
launches per wrapper.
"""

from __future__ import annotations

import torch

from wavelet_tpu_torch.core import haar, threshold
from wavelet_tpu_torch.kernels.haar_cuda import _check, _raise_if, _stream

__all__ = ["lane_pack_factor", "packed_forward", "packed_inverse",
           "packed_forward_hist", "packed_forward_plain",
           "packed_inverse_plain", "packed_forward_hist_plain", "unpack",
           "launches", "reset_launches"]

launches = {"packed_forward": 0, "packed_inverse": 0,
            "packed_forward_hist": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def lane_pack_factor(dims) -> int:
    """Boxes per 128-lane row for shape (X, Y, Z): P = 128 // Z when an even
    Z evenly fills 128 lanes, else 1 (the JAX package's rule,
    ``haar_pallas.lane_pack_factor``)."""
    z = int(dims[-1])
    if 0 < z < 128 and 128 % z == 0 and z % 2 == 0:
        return 128 // z
    return 1


def unpack(x: torch.Tensor, pack: int) -> torch.Tensor:
    """``[M, X, Y, P*Z]`` -> item-major ``[M*P, X, Y, Z]`` (a copy)."""
    m, X, Y, L = x.shape
    return (x.reshape(m, X, Y, pack, L // pack).permute(0, 3, 1, 2, 4)
            .reshape(m * pack, X, Y, L // pack))


def _repack(c: torch.Tensor, pack: int) -> torch.Tensor:
    """Item-major ``[M*P, X, Y, Z]`` -> ``[M, X, Y, P*Z]``."""
    n, X, Y, Z = c.shape
    return (c.reshape(n // pack, pack, X, Y, Z).permute(0, 2, 3, 1, 4)
            .reshape(n // pack, X, Y, pack * Z))


def packed_forward_plain(x: torch.Tensor, pack: int):
    """Plain PyTorch: ``(packed coeffs, max [M*P], min [M*P])``; the
    reductions propagate NaN (``torch.amax``, as ``jnp.max``)."""
    c = haar.haar3d_forward(unpack(x, pack))
    flat = c.reshape(c.shape[0], -1)
    return _repack(c, pack), flat.amax(dim=1), flat.amin(dim=1)


def packed_inverse_plain(c: torch.Tensor, pack: int) -> torch.Tensor:
    return _repack(haar.haar3d_inverse(unpack(c, pack)), pack)


def packed_forward_hist_plain(x: torch.Tensor, pack: int):
    """Plain PyTorch: ``(packed coeffs, int64 histogram of the batch)``."""
    c = haar.haar3d_forward(unpack(x, pack))
    return _repack(c, pack), threshold.abs_exponent_histogram(c)


def _check_packed(t: torch.Tensor, pack: int, what: str):
    """-> (M, X, Y, L) of a packed batch the kernels take."""
    _check(t, what)
    M, X, Y, L = (int(d) for d in t.shape)
    if pack < 1 or L % pack or (L // pack) % 2:
        raise ValueError(f"{what}: lane width {L} is not {pack} boxes of an "
                         "even Z")
    return M, X, Y, L


def packed_forward(x: torch.Tensor, pack: int):
    """``[M, X, Y, P*Z]`` f32 -> ``(coeffs [M, X, Y, P*Z], max [M*P],
    min [M*P])``; exact ties ``min == -max`` are resolved by the caller
    (``runtime/engine.resolve_signed_absmax``)."""
    M, X, Y, L = _check_packed(x, pack, "packed_forward")
    if x.device.type == "cpu":
        return packed_forward_plain(x, pack)
    from wavelet_tpu_torch.kernels import build

    lib = build.library()
    c = torch.empty_like(x)
    ext = torch.empty((2, M * pack), dtype=x.dtype, device=x.device)
    keys = torch.empty(2 * M * pack, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.wt_packed_forward(x.data_ptr(), c.data_ptr(),
                                    ext[0].data_ptr(), ext[1].data_ptr(),
                                    keys.data_ptr(), M, X, Y, L, pack,
                                    _stream(x))
    _raise_if(err, lib, "packed_forward")
    launches["packed_forward"] += 1
    return c, ext[0], ext[1]


def packed_forward_hist(x: torch.Tensor, pack: int):
    """``[M, X, Y, P*Z]`` f32 -> ``(coeffs, int64 [2048] histogram of
    (bits & 0x7FFFFFFF) >> 20 over every coefficient of the batch)``."""
    M, X, Y, L = _check_packed(x, pack, "packed_forward_hist")
    if x.device.type == "cpu":
        return packed_forward_hist_plain(x, pack)
    from wavelet_tpu_torch.kernels import build

    lib = build.library()
    c = torch.empty_like(x)
    hist = torch.empty(threshold.EXP_HIST_BINS, dtype=torch.int64,
                       device=x.device)
    with torch.cuda.device(x.device):
        err = lib.wt_packed_forward_hist(x.data_ptr(), c.data_ptr(),
                                         hist.data_ptr(), M, X, Y, L, pack,
                                         _stream(x))
    _raise_if(err, lib, "packed_forward_hist")
    launches["packed_forward_hist"] += 1
    return c, hist


def packed_inverse(c: torch.Tensor, pack: int) -> torch.Tensor:
    """``[M, X, Y, P*Z]`` coefficients -> ``[M, X, Y, P*Z]`` boxes."""
    M, X, Y, L = _check_packed(c, pack, "packed_inverse")
    if c.device.type == "cpu":
        return packed_inverse_plain(c, pack)
    from wavelet_tpu_torch.kernels import build

    lib = build.library()
    out = torch.empty_like(c)
    with torch.cuda.device(c.device):
        err = lib.wt_packed_inverse(c.data_ptr(), out.data_ptr(), M, X, Y, L,
                                    pack, _stream(c))
    _raise_if(err, lib, "packed_inverse")
    launches["packed_inverse"] += 1
    return out
