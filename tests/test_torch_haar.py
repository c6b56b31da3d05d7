"""The port's torch Haar transforms against the JAX package and the
reference oracle, bitwise (int32 views).

Subnormals: the port keeps them, as the reference's double-precision loops
do, so it matches ``core/oracle`` bitwise on subnormal inputs.  JAX's CPU
backend flushes subnormals to zero (XLA runs with FTZ/DAZ set), so on
subnormal inputs the port is held to JAX with the same flush enabled in
PyTorch (``torch.set_flush_denormal``) — the identical arithmetic under
the identical float environment.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from wavelet_tpu.core import haar as jhaar  # noqa: E402
from wavelet_tpu.core import oracle  # noqa: E402
from wavelet_tpu_torch.core import haar  # noqa: E402

SHAPES = [(1, 1, 1), (2, 2, 2), (3, 5, 7), (8, 4, 2), (16, 32, 64),
          (33, 17, 9)]


def _batch(shape, kind: str, seed: int, n: int = 2) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return (rng.standard_normal((n,) + shape) * 50).astype(np.float32)
    # subnormal: tiny normals with every third element deep in the
    # subnormal range
    x = (rng.standard_normal((n,) + shape) * 1e-37).astype(np.float32)
    flat = x.reshape(-1)
    flat[::3] = (rng.standard_normal(flat[::3].size) * 1e-42).astype(
        np.float32)
    return x


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


@contextlib.contextmanager
def _flush_denormal():
    assert torch.set_flush_denormal(True), "CPU cannot flush denormals"
    try:
        yield
    finally:
        torch.set_flush_denormal(False)


def test_subnormal_inputs_are_subnormal():
    x = _batch((33, 17, 9), "subnormal", 0)
    sub = (np.abs(x) < np.finfo(np.float32).tiny) & (x != 0)
    assert sub.sum() > x.size // 4


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_inverse_match_jax(shape):
    x = _batch(shape, "normal", 1)
    got = haar.haar3d_forward(torch.from_numpy(x))
    want = jhaar.haar3d_forward(jnp.asarray(x))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    inv = haar.haar3d_inverse(got)
    np.testing.assert_array_equal(
        _bits(inv), _bits(jhaar.haar3d_inverse(jnp.asarray(np.asarray(want)))))


@pytest.mark.parametrize("shape", SHAPES)
def test_subnormals_match_jax_under_its_flush(shape):
    x = _batch(shape, "subnormal", 2)
    c = np.array(jhaar.haar3d_forward(jnp.asarray(x)))
    with _flush_denormal():
        got = haar.haar3d_forward(torch.from_numpy(x))
        inv = haar.haar3d_inverse(torch.from_numpy(c))
    np.testing.assert_array_equal(_bits(got), _bits(c))
    np.testing.assert_array_equal(
        _bits(inv), _bits(jhaar.haar3d_inverse(jnp.asarray(c))))


@pytest.mark.parametrize("kind", ["normal", "subnormal"])
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_inverse_match_oracle(shape, kind):
    x = _batch(shape, kind, 3)
    got = haar.haar3d_forward(torch.from_numpy(x)).numpy()
    for i in range(x.shape[0]):
        want = oracle.haar_forward_oracle(x[i])
        np.testing.assert_array_equal(_bits(got[i]).reshape(-1), _bits(want))
        np.testing.assert_array_equal(
            _bits(haar.haar3d_inverse(torch.from_numpy(got[i])).numpy()),
            _bits(oracle.haar_inverse_oracle(want, *shape)))


def test_flat_entry_points_match_jax():
    x = _batch((6, 5, 4), "normal", 4, n=3)
    flat = haar.forward_flat(torch.from_numpy(x))
    want = jhaar.forward_flat(jnp.asarray(x))
    assert tuple(flat.shape) == (3, 6 * 5 * 4)
    np.testing.assert_array_equal(_bits(flat), _bits(want))
    np.testing.assert_array_equal(
        _bits(haar.inverse_from_flat(flat, (6, 5, 4))),
        _bits(jhaar.inverse_from_flat(want, (6, 5, 4))))


def test_odd_tails_forward_pass_through_inverse_zeroes():
    x = _batch((3, 5, 7), "normal", 5, n=1)
    c = haar.haar3d_forward(torch.from_numpy(x))
    # the last X plane's last (Y, Z) element is untouched by every pass
    assert float(c[0, 2, 4, 6]) == float(x[0, 2, 4, 6])
    out = haar.haar3d_inverse(c)
    assert not out[0, 2].any() and not out[0, :, 4].any() \
        and not out[0, :, :, 6].any()
