"""Fused single-pass Haar kernels for Hopper: wrappers, plain versions and
launch counts.

- :func:`fused_forward` ``[N, X, Y, Z] -> (coeffs, max [N], min [N])``
  replaces ``wavelet_tpu/kernels/haar_pallas.py:_fused_forward_call``;
- :func:`fused_inverse` ``[N, X, Y, Z] -> [N, X, Y, Z]`` replaces
  ``haar_pallas.py:_fused_inverse_call``.

The kernels are the one-scale case of the pyramid kernels in CUDA C++
(``wavelet_tpu_torch/csrc/pyramid.cu``, ``scales=1``), built by
:mod:`wavelet_tpu_torch.kernels.build`; :func:`_launch_forward` and
:func:`_launch_inverse` launch them at any depth for both wrapper modules.  A CUDA tensor launches the kernel
or raises; a CPU tensor goes to the plain PyTorch version below
(:func:`fused_forward_plain` / :func:`fused_inverse_plain`), which is also
what the kernels are held to on the card.  ``launches`` counts kernel
launches per wrapper, so a run can show that it went through the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from wavelet_tpu_torch.core import haar

__all__ = ["fused_forward", "fused_inverse", "fused_forward_plain",
           "fused_inverse_plain", "launches", "reset_launches"]

launches = {"haar_forward": 0, "haar_inverse": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def fused_forward_plain(x: torch.Tensor):
    """Plain PyTorch forward: ``(coeffs, max, min)`` per box; the
    reductions propagate NaN (``torch.amax``, as ``jnp.max``)."""
    c = haar.haar3d_forward(x)
    flat = c.reshape(c.shape[0], -1)
    return c, flat.amax(dim=1), flat.amin(dim=1)


def fused_inverse_plain(c: torch.Tensor) -> torch.Tensor:
    return haar.haar3d_inverse(c)


def _check(t: torch.Tensor, what: str) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{what}: expected float32, got {t.dtype}")
    if t.dim() != 4:
        raise ValueError(f"{what}: expected [N, X, Y, Z], got shape "
                         f"{tuple(t.shape)}")
    if min(t.shape) <= 0:
        raise ValueError(f"{what}: empty shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")
    if t.device.type == "cuda" and t.data_ptr() % 16:
        raise ValueError(f"{what}: CUDA tensor must be 16-byte aligned")


def _raise_if(err: int, lib, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} "
                           f"({lib.wt_error_string(err).decode()})")


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _scratch(lib, t: torch.Tensor, scales: int) -> torch.Tensor:
    n, X, Y, Z = (int(d) for d in t.shape)
    per_box = int(lib.wt_pyramid_scratch(X, Y, Z, scales))
    return torch.empty(max(1, n * per_box), dtype=t.dtype, device=t.device)


def _launch_forward(x: torch.Tensor, scales: int, what: str):
    """Launch ``wt_pyramid_forward`` on a checked CUDA tensor: ->
    ``(coeffs, max [N], min [N])``.  The caller counts the launch."""
    from wavelet_tpu_torch.kernels import build

    lib = build.library()
    n, X, Y, Z = (int(d) for d in x.shape)
    n_part = int(lib.wt_pyramid_forward_parts(X, Y, Z, scales))
    c = torch.empty_like(x)
    maxv = torch.empty(n, dtype=x.dtype, device=x.device)
    minv = torch.empty(n, dtype=x.dtype, device=x.device)
    part = torch.empty((2, n, n_part), dtype=x.dtype, device=x.device)
    scratch = _scratch(lib, x, scales)
    with torch.cuda.device(x.device):
        err = lib.wt_pyramid_forward(
            x.data_ptr(), c.data_ptr(), maxv.data_ptr(), minv.data_ptr(),
            part[0].data_ptr(), part[1].data_ptr(), scratch.data_ptr(), n, X,
            Y, Z, scales, _stream(x))
    _raise_if(err, lib, what)
    return c, maxv, minv


def _launch_inverse(c: torch.Tensor, scales: int, what: str) -> torch.Tensor:
    """Launch ``wt_pyramid_inverse`` on a checked CUDA tensor; the caller
    counts the launch."""
    from wavelet_tpu_torch.kernels import build

    lib = build.library()
    n, X, Y, Z = (int(d) for d in c.shape)
    out = torch.empty_like(c)
    scratch = _scratch(lib, c, scales)
    with torch.cuda.device(c.device):
        err = lib.wt_pyramid_inverse(c.data_ptr(), out.data_ptr(),
                                     scratch.data_ptr(), n, X, Y, Z, scales,
                                     _stream(c))
    _raise_if(err, lib, what)
    return out


def fused_forward(x: torch.Tensor):
    """``[N, X, Y, Z]`` f32 -> ``(coeffs [N, X, Y, Z], max [N], min [N])``.

    The signed extremum the threshold needs is ``max`` if ``|max| >=
    |min|`` else ``min``; exact ties are resolved by the caller on the
    first-occurrence rule (runtime/engine.resolve_signed_absmax)."""
    _check(x, "fused_forward")
    if x.device.type == "cpu":
        return fused_forward_plain(x)
    out = _launch_forward(x, 1, "haar_forward")
    launches["haar_forward"] += 1
    return out


def fused_inverse(c: torch.Tensor) -> torch.Tensor:
    """``[N, X, Y, Z]`` coefficients -> ``[N, X, Y, Z]`` boxes."""
    _check(c, "fused_inverse")
    if c.device.type == "cpu":
        return fused_inverse_plain(c)
    out = _launch_inverse(c, 1, "haar_inverse")
    launches["haar_inverse"] += 1
    return out
