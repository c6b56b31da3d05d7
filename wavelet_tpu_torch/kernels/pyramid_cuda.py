"""Multi-scale Haar pyramid kernels and the fused histogram for Hopper:
wrappers, plain versions and launch counts.

- :func:`pyramid_forward` ``[N, X, Y, Z], scales -> (coeffs, max [N],
  min [N])`` replaces
  ``wavelet_tpu/kernels/haar_pallas.py:_fwd_interleaved_call``;
- :func:`forward_hist` ``[N, X, Y, Z], scales -> (coeffs, int64 [2048])``
  replaces ``haar_pallas.py:_fwd_interleaved_nored_call`` together with the
  ``abs_exponent_histogram`` step the JAX engine runs after it;
- :func:`pyramid_inverse` ``[N, X, Y, Z], scales -> [N, X, Y, Z]``
  replaces ``haar_pallas.py:_inv_interleaved_call``.

Coefficients are in the halves (logical) layout of
:func:`wavelet_tpu_torch.core.haar.haar3d_forward_multi`, not the TPU
kernels' interleaved one.  The kernels are CUDA C++
(``wavelet_tpu_torch/csrc/pyramid.cu``), built by
:mod:`wavelet_tpu_torch.kernels.build`.  A CUDA tensor launches the kernel
or raises; a CPU tensor goes to the plain PyTorch version below, which is
also what the kernels are held to on the card.  ``launches`` counts kernel
launches per wrapper.

Shapes: scale 0 takes any dims; each deeper scale's corner ``[X >> s,
Y >> s, Z >> s]`` must be even and non-empty (the engine's ``eff_scales``
only asks for pyramids whose dims all divide by ``2**scales``).
"""

from __future__ import annotations

import torch

from wavelet_tpu_torch.core import haar, threshold
from wavelet_tpu_torch.kernels.haar_cuda import (_check, _launch_forward,
                                                 _launch_inverse, _raise_if,
                                                 _scratch, _stream)

__all__ = ["pyramid_forward", "forward_hist", "pyramid_inverse",
           "pyramid_forward_plain", "forward_hist_plain",
           "pyramid_inverse_plain", "launches", "reset_launches"]

launches = {"pyramid_forward": 0, "forward_hist": 0, "pyramid_inverse": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def pyramid_forward_plain(x: torch.Tensor, scales: int):
    """Plain PyTorch: ``(coeffs, max, min)`` per box (NaN-propagating)."""
    c = haar.haar3d_forward_multi(x, scales)
    flat = c.reshape(c.shape[0], -1)
    return c, flat.amax(dim=1), flat.amin(dim=1)


def forward_hist_plain(x: torch.Tensor, scales: int):
    """Plain PyTorch: ``(coeffs, int64 histogram of the whole batch)``."""
    c = haar.haar3d_forward_multi(x, scales)
    return c, threshold.abs_exponent_histogram(c)


def pyramid_inverse_plain(c: torch.Tensor, scales: int) -> torch.Tensor:
    return haar.haar3d_inverse_multi(c, scales)


def _check_scales(t: torch.Tensor, scales: int, what: str) -> None:
    X, Y, Z = (int(d) for d in t.shape[1:])
    if scales < 1:
        raise ValueError(f"{what}: scales must be >= 1, got {scales}")
    for s in range(1, scales):
        corner = (X >> s, Y >> s, Z >> s)
        if any(d % 2 or d == 0 for d in corner):
            raise ValueError(
                f"{what}: dims {(X, Y, Z)}: scale-{s} corner {corner} is "
                "odd or empty — deeper scales need even corner dims")


def pyramid_forward(x: torch.Tensor, scales: int):
    """``[N, X, Y, Z]`` f32 -> ``(pyramid coeffs, max [N], min [N])``."""
    _check(x, "pyramid_forward")
    _check_scales(x, scales, "pyramid_forward")
    if x.device.type == "cpu":
        return pyramid_forward_plain(x, scales)
    out = _launch_forward(x, scales, "pyramid_forward")
    launches["pyramid_forward"] += 1
    return out


def forward_hist(x: torch.Tensor, scales: int):
    """``[N, X, Y, Z]`` f32 -> ``(pyramid coeffs, int64 [2048] histogram
    of (bits & 0x7FFFFFFF) >> 20 over every coefficient of the batch)``."""
    _check(x, "forward_hist")
    _check_scales(x, scales, "forward_hist")
    if x.device.type == "cpu":
        return forward_hist_plain(x, scales)
    from wavelet_tpu_torch.kernels import build

    lib = build.library()
    n, X, Y, Z = (int(d) for d in x.shape)
    c = torch.empty_like(x)
    hist = torch.empty(threshold.EXP_HIST_BINS, dtype=torch.int64,
                       device=x.device)
    scratch = _scratch(lib, x, scales)
    with torch.cuda.device(x.device):
        err = lib.wt_forward_hist(x.data_ptr(), c.data_ptr(), hist.data_ptr(),
                                  scratch.data_ptr(), n, X, Y, Z, scales,
                                  _stream(x))
    _raise_if(err, lib, "forward_hist")
    launches["forward_hist"] += 1
    return c, hist


def pyramid_inverse(c: torch.Tensor, scales: int) -> torch.Tensor:
    """``[N, X, Y, Z]`` pyramid coefficients -> ``[N, X, Y, Z]`` boxes."""
    _check(c, "pyramid_inverse")
    _check_scales(c, scales, "pyramid_inverse")
    if c.device.type == "cpu":
        return pyramid_inverse_plain(c, scales)
    out = _launch_inverse(c, scales, "pyramid_inverse")
    launches["pyramid_inverse"] += 1
    return out
