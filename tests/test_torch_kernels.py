"""The fused Haar kernels' wrappers and plain versions, and the threshold
pieces, against the JAX package, bitwise (int32 views).

On the CPU the wrappers run their plain PyTorch versions; these are held
to the Pallas kernels ``haar_pallas._fused_forward_call`` /
``_fused_inverse_call`` in interpret mode, as tests/test_pallas_kernels.py
runs them.  One exception to bitwise equality: a zero extremum may be +0.0
from one and -0.0 from the other; its sign cannot change ``|c| > t32``,
so it cannot change an archive byte.  The kernels themselves run only on
the card: tests/test_torch_cuda.py holds them to the plain versions there.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from wavelet_tpu.core import threshold as jthreshold  # noqa: E402
from wavelet_tpu.kernels import haar_pallas as hp  # noqa: E402
from wavelet_tpu.runtime import engine as jengine  # noqa: E402
from wavelet_tpu_torch.core import threshold  # noqa: E402
from wavelet_tpu_torch.kernels import build, haar_cuda  # noqa: E402
from wavelet_tpu_torch.runtime import engine  # noqa: E402

SHAPES = [(4, 8, 16), (8, 4, 2), (3, 5, 7), (1, 1, 1), (33, 17, 9)]


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _same_extrema(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    same = (_bits(got) == _bits(want)) | ((got == 0) & (want == 0))
    assert same.all(), (got, want)


def _batch(shape, seed, n=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n,) + shape) * 50).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_plain_matches_pallas_interpret(shape):
    x = _batch(shape, 0)
    x[1] = 0.0     # an all-zero box: zero extrema
    c, mx, mn = haar_cuda.fused_forward(torch.from_numpy(x))
    jc, jmx, jmn = hp._fused_forward_call(jnp.asarray(x), interpret=True)
    np.testing.assert_array_equal(_bits(c), _bits(jc))
    _same_extrema(mx, jmx)
    _same_extrema(mn, jmn)


@pytest.mark.parametrize("shape", SHAPES)
def test_inverse_plain_matches_pallas_interpret(shape):
    c = _batch(shape, 1)
    got = haar_cuda.fused_inverse(torch.from_numpy(c))
    want = hp._fused_inverse_call(jnp.asarray(c), interpret=True)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_forward_extrema_propagate_nan():
    x = _batch((3, 5, 7), 2)
    x[2, 1, 1, 1] = np.nan
    c, mx, mn = haar_cuda.fused_forward(torch.from_numpy(x))
    jc, jmx, jmn = hp._fused_forward_call(jnp.asarray(x), interpret=True)
    assert np.isnan(float(mx[2])) and np.isnan(float(mn[2]))
    assert np.isnan(np.asarray(jmx)[2]) and np.isnan(np.asarray(jmn)[2])
    _same_extrema(mx[:2], np.asarray(jmx)[:2])
    _same_extrema(mn[:2], np.asarray(jmn)[:2])


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    before = dict(haar_cuda.launches)
    x = torch.from_numpy(_batch((4, 4, 4), 3))
    c, _, _ = haar_cuda.fused_forward(x)
    haar_cuda.fused_inverse(c)
    assert haar_cuda.launches == before


@pytest.mark.parametrize("bad,err", [
    (torch.zeros((2, 4, 4, 4), dtype=torch.float64), TypeError),
    (torch.zeros((4, 4, 4)), ValueError),
    (torch.zeros((2, 4, 4, 8))[..., ::2], ValueError),
    (torch.zeros((0, 4, 4, 4)), ValueError),
])
def test_wrappers_reject_bad_input(bad, err):
    with pytest.raises(err):
        haar_cuda.fused_forward(bad)
    with pytest.raises(err):
        haar_cuda.fused_inverse(bad)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc -> the build raises; nothing falls back to the plain path."""
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "nocuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.library()


def test_engine_refuses_cuda_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        engine.CodecEngine(device="cuda")


def test_signed_absmax_ties_nan_match_jax():
    rng = np.random.default_rng(4)
    rows = (rng.standard_normal((6, 40)) * 10).astype(np.float32)
    rows[0, 3], rows[0, 7] = -55.0, 55.0      # tie: -55 comes first
    rows[1, 2], rows[1, 9] = 55.0, -55.0      # tie: +55 comes first
    rows[2, 5], rows[2, 6] = 55.0, 55.0       # equal values
    rows[3] = 0.0
    rows[4, 11] = np.nan
    rows[5, 0], rows[5, 1] = -np.inf, np.inf
    got = threshold.signed_absmax(torch.from_numpy(rows))
    want = jthreshold.signed_absmax(jnp.asarray(rows))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert float(got[0]) == -55.0 and float(got[1]) == 55.0


def test_resolve_signed_absmax_matches_jax():
    rng = np.random.default_rng(5)
    rows = (rng.standard_normal((7, 24)) * 3).astype(np.float32)
    rows[0, 4], rows[0, 9] = -9.0, 9.0
    rows[1, 1], rows[1, 20] = 9.0, -9.0
    rows[2] = 0.0
    rows[3, 0] = np.nan
    maxv, minv = rows.max(axis=1), rows.min(axis=1)
    got = engine.resolve_signed_absmax(maxv.copy(), minv.copy(),
                                       row_getter=rows.__getitem__)
    want = jengine.resolve_signed_absmax(maxv.copy(), minv.copy(),
                                         flat_dev=jnp.asarray(rows))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert got[0] == -9.0 and got[1] == 9.0


def test_fused_signed_absmax_equals_jax_argmax_path():
    """The port's (max, min) + tie resolution gives JAX's CPU path's
    ``argmax`` result (engine._compress_step) on boxes with ties."""
    x = _batch((8, 4, 2), 6, n=5)
    x[0] = 0.0
    x[0, 1, 0, 0] = 8.0          # coefficients +1 / -1 only: a tie
    x[1] = -x[1]
    c, mx, mn = haar_cuda.fused_forward(torch.from_numpy(x))
    flat = c.numpy().reshape(5, -1)
    got = engine.resolve_signed_absmax(mx.numpy(), mn.numpy(),
                                       row_getter=flat.__getitem__)
    _, want = jengine._compress_step(jnp.asarray(x))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert got[0] == 1.0


@pytest.mark.parametrize("keep", [0.999, 0.5, 0.0, 1.0, 0.9999999])
def test_exact_threshold32_matches_jax(keep):
    rng = np.random.default_rng(7)
    vals = np.concatenate([
        (rng.standard_normal(200) * 10.0 ** rng.integers(-40, 38, 200)),
        [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45, 3.4e38],
    ]).astype(np.float32)
    got = threshold.exact_threshold32(vals, keep)
    want = jthreshold.exact_threshold32(vals, keep)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_engine_batch_entry_points_match_jax():
    """CodecEngine's array-level entry points against the JAX engine's CPU
    path: coefficients, signed extrema, thresholds, reconstructions."""
    x = _batch((9, 6, 4), 9, n=4)
    x[0] = 0.0
    x[0, 1, 0, 0] = 8.0
    eng, jeng = engine.CodecEngine(device="cpu"), jengine.CodecEngine()
    flat, signed = eng.forward_signed_batch(x)
    jflat, jsigned = jeng.forward_signed_batch(x)
    np.testing.assert_array_equal(_bits(flat), _bits(jflat))
    np.testing.assert_array_equal(_bits(signed), _bits(jsigned))
    flat, t32 = eng.compress_batch_raw(x, 0.999)
    np.testing.assert_array_equal(
        _bits(t32), _bits(jeng.compress_batch_raw(x, 0.999)[1]))
    np.testing.assert_array_equal(
        _bits(eng.decompress_batch(flat, (9, 6, 4))),
        _bits(jeng.decompress_batch(jflat, (9, 6, 4))))
