"""The one-scale plain versions at the box shapes the CUDA kernels K1/K2
are timed and checked at, against the JAX package, bitwise.

``haar_cuda.fused_forward_plain`` / ``fused_inverse_plain`` are what the
kernels are held to on the card (``chip_smoke.py``), so they are held here
to the Pallas kernels ``haar_pallas._fused_forward_call`` /
``_fused_inverse_call`` in interpret mode, as tests/test_pallas_kernels.py
runs them: small, cubic and odd boxes, single cells and tails on every
axis, with NaN, +-inf, signed zeros, an exact ``min == -max`` tie and
subnormals among normal boxes.  Comparisons are on int32 views, with two
exceptions: any NaN equals any NaN (payloads are the CPU's), and a zero
extremum may be +0.0 on one side and -0.0 on the other (its sign cannot
change ``|c| > t32``).  JAX's CPU backend flushes subnormals, so the
subnormal cases run the port under ``torch.set_flush_denormal(True)``;
there the extrema compare with subnormals read as zero on both sides
(torch's reductions then read them so, while XLA's max of a 1x1x1 box, a
copy, keeps the subnormal input it never computed with).
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from wavelet_tpu.kernels import haar_pallas as hp  # noqa: E402
from wavelet_tpu.runtime import engine as jengine  # noqa: E402
from wavelet_tpu_torch.kernels import haar_cuda  # noqa: E402
from wavelet_tpu_torch.runtime import engine  # noqa: E402

# the sweep's small and odd boxes and the checks' single cells and tails
BOX_SHAPES = [(8, 4, 2), (8, 8, 8), (9, 17, 33), (2, 2, 2), (1, 1, 1),
              (1, 2, 3)]
N_BOX = 6


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _daz(a) -> np.ndarray:
    a = np.asarray(a, np.float32)
    return np.where(np.abs(a) < np.finfo(np.float32).tiny, np.float32(0), a)


def _assert_same(got, want, zero_sign_ok=False):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    same = (_bits(got) == _bits(want)) | (np.isnan(got) & np.isnan(want))
    if zero_sign_ok:
        same |= (got == 0) & (want == 0)
    assert same.all(), np.argwhere(~same)[:5]


def _boxes(shape, kind: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((N_BOX,) + shape) * 50).astype(np.float32)
    if kind == "subnormal":
        x *= np.float32(2e-39)
        flat = x.reshape(-1)
        flat[::3] = (rng.standard_normal(flat[::3].size) * 1e-42).astype(
            np.float32)
        return x
    if kind == "special":
        flat = x.reshape(N_BOX, -1)
        flat[1, min(1, flat.shape[1] - 1)] = np.nan
        x[2] = -0.0
        # one nonzero at index 1 of the first axis that has one: the
        # coefficients are then +v and -v, an exact tie
        axis = next((a for a, d in enumerate(shape) if d > 1), None)
        if axis is not None:
            x[3] = 0.0
            at = [0, 0, 0]
            at[axis] = 1
            x[(3, *at)] = 8.0
        flat[4, 0] = np.inf
        flat[4, -1] = -np.inf if flat.shape[1] > 1 else np.inf
        flat[5] *= np.float32(1e-3)
    return x


@contextlib.contextmanager
def _float_env(kind: str):
    if kind != "subnormal":
        yield
        return
    assert torch.set_flush_denormal(True), "CPU cannot flush denormals"
    try:
        yield
    finally:
        torch.set_flush_denormal(False)


@pytest.mark.parametrize("kind", ["normal", "special", "subnormal"])
@pytest.mark.parametrize("shape", BOX_SHAPES)
def test_plain_versions_match_pallas_at_sweep_boxes(shape, kind):
    x = _boxes(shape, kind, seed=sum(shape))
    jc, jmx, jmn = hp._fused_forward_call(jnp.asarray(x), interpret=True)
    jc = np.array(jc)      # a writable copy for torch.from_numpy
    jinv = {what: np.asarray(hp._fused_inverse_call(jnp.asarray(c),
                                                    interpret=True))
            for what, c in (("coeffs", jc), ("raw", x))}
    with _float_env(kind):
        c, mx, mn = haar_cuda.fused_forward_plain(torch.from_numpy(x))
        inv = {what: haar_cuda.fused_inverse_plain(torch.from_numpy(a))
               for what, a in (("coeffs", jc), ("raw", x))}
    _assert_same(c, jc)
    ext = _daz if kind == "subnormal" else np.asarray
    _assert_same(ext(mx), ext(jmx), zero_sign_ok=True)
    _assert_same(ext(mn), ext(jmn), zero_sign_ok=True)
    for what in inv:
        _assert_same(inv[what], jinv[what])
    # the signed extremum the threshold takes, ties broken on the
    # coefficients' first occurrence
    flat = c.reshape(N_BOX, -1).numpy()
    got = engine.resolve_signed_absmax(mx.numpy(), mn.numpy(),
                                       row_getter=flat.__getitem__)
    want = jengine.resolve_signed_absmax(
        np.asarray(jmx), np.asarray(jmn),
        flat_dev=jnp.asarray(jc.reshape(N_BOX, -1)))
    _assert_same(ext(got), ext(want), zero_sign_ok=True)
    if kind == "special" and max(shape) > 1:
        assert got[3] == flat[3][np.argmax(np.abs(flat[3]))] != 0
        assert np.isnan(float(mx[1])) and np.isnan(float(mn[1]))
