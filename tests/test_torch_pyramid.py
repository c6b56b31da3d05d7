"""The port's multi-scale pyramids, the magnitude histogram and the global
threshold against the JAX package, bitwise (int32 views) unless stated.

On the CPU the wrappers of ``kernels/pyramid_cuda.py`` run their plain
PyTorch versions.  These are held to the Pallas kernels K5/K6/K7
(``haar_pallas.fused_forward_interleaved``,
``fused_forward_interleaved_nored`` and ``fused_inverse_interleaved``,
which fall to interpret mode on the CPU, as tests/test_interleaved.py
runs them): the TPU kernels keep coefficients interleaved, so their
output is read through ``haar_pallas.interleave_map_multi`` into the
logical order the port writes.  A zero extremum may be +0.0 from one and
-0.0 from the other; its sign cannot change ``|c| > t32``.  The kernels
themselves run only on the card (tests/test_torch_cuda.py).
"""

import contextlib

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from wavelet_tpu.core import haar as jhaar  # noqa: E402
from wavelet_tpu.core import threshold as jthreshold  # noqa: E402
from wavelet_tpu.kernels import haar_pallas as hp  # noqa: E402
from wavelet_tpu.runtime import batching  # noqa: E402
from wavelet_tpu.runtime import engine as jengine  # noqa: E402
from wavelet_tpu_torch.core import haar, threshold  # noqa: E402
from wavelet_tpu_torch.kernels import pyramid_cuda  # noqa: E402
from wavelet_tpu_torch.runtime import engine  # noqa: E402

MULTI = [((8, 8, 8), 2), ((16, 8, 8), 3), ((8, 4, 4), 2), ((32, 16, 8), 3),
         ((9, 4, 8), 2), ((4, 4, 4), 2), ((16, 16, 16), 4)]
# (dims, pack, scales) as tests/test_interleaved.py runs K5/K7
KERNEL_CASES = [((8, 8, 8), 2, 2), ((16, 8, 8), 1, 3), ((8, 4, 4), 4, 2),
                ((8, 8, 8), 1, 3)]


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _same_extrema(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    same = (_bits(got) == _bits(want)) | ((got == 0) & (want == 0))
    assert same.all(), (got, want)


def _batch(shape, seed, n=2, scale=50.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n,) + tuple(shape)) * scale).astype(
        np.float32)


def _subnormal(shape, seed, n=2):
    x = _batch(shape, seed, n, 1e-37)
    flat = x.reshape(-1)
    flat[::3] = _batch(flat[::3].shape, seed + 1, 1, 1e-42).reshape(-1)
    return x


@contextlib.contextmanager
def _flush_denormal():
    assert torch.set_flush_denormal(True), "CPU cannot flush denormals"
    try:
        yield
    finally:
        torch.set_flush_denormal(False)


def _packed(boxes, pack):
    n, x, y, z = boxes.shape
    return np.ascontiguousarray(
        boxes.reshape(n // pack, pack, x, y, z).transpose(0, 2, 3, 1, 4)
        .reshape(n // pack, x, y, pack * z))


def _logical(c, dims, pack, scales):
    """Interleaved packed K5/K6 output -> logical [n, X, Y, Z]."""
    x, y, z = dims
    L = pack * z
    fmap = hp.interleave_map_multi(dims, scales, y * L, L, 1)
    flat = np.asarray(c).reshape(-1)
    out = []
    for i in range(c.shape[0] * pack):
        m, p = divmod(i, pack)
        out.append(flat[m * (x * y * L) + p * z + fmap].reshape(dims))
    return np.stack(out)


# ---- core/haar multi-scale transforms ---------------------------------

@pytest.mark.parametrize("dims,scales", MULTI)
def test_multi_forward_inverse_match_jax(dims, scales):
    x = _batch(dims, 1)
    got = haar.haar3d_forward_multi(torch.from_numpy(x), scales)
    want = np.asarray(jhaar.haar3d_forward_multi(jnp.asarray(x), scales))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    inv = haar.haar3d_inverse_multi(got, scales)
    np.testing.assert_array_equal(
        _bits(inv), _bits(jhaar.haar3d_inverse_multi(jnp.asarray(want),
                                                     scales)))
    # the caller's tensors are not written
    assert (_bits(x) == _bits(_batch(dims, 1))).all()
    assert (_bits(got) == _bits(want)).all()


@pytest.mark.parametrize("dims,scales", [((8, 8, 8), 2), ((16, 8, 8), 3),
                                         ((9, 4, 8), 2)])
def test_multi_subnormals_match_jax_under_its_flush(dims, scales):
    x = _subnormal(dims, 2)
    c = np.array(jhaar.haar3d_forward_multi(jnp.asarray(x), scales))
    with _flush_denormal():
        got = haar.haar3d_forward_multi(torch.from_numpy(x), scales)
        inv = haar.haar3d_inverse_multi(torch.from_numpy(c), scales)
    np.testing.assert_array_equal(_bits(got), _bits(c))
    np.testing.assert_array_equal(
        _bits(inv), _bits(jhaar.haar3d_inverse_multi(jnp.asarray(c), scales)))


@pytest.mark.parametrize("dims,scales", [((8, 4, 2), 2), ((6, 8, 8), 2),
                                         ((8, 8, 4), 3)])
def test_multi_odd_deeper_corner_raises_like_jax(dims, scales):
    x = _batch(dims, 3)
    with pytest.raises(ValueError) as jerr:
        jhaar.haar3d_forward_multi(jnp.asarray(x), scales)
    with pytest.raises(ValueError) as terr:
        haar.haar3d_forward_multi(torch.from_numpy(x), scales)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="corner"):
        pyramid_cuda.pyramid_forward(torch.from_numpy(x), scales)


# ---- the plain kernel versions against K5 / K6 / K7 --------------------

@pytest.mark.parametrize("dims,pack,scales", KERNEL_CASES)
def test_pyramid_forward_plain_matches_k5_interpret(dims, pack, scales):
    boxes = _batch(dims, 4, n=2 * pack)
    boxes[1] = 0.0                       # zero extrema
    c, jmx, jmn = hp.fused_forward_interleaved(
        jnp.asarray(_packed(boxes, pack)), pack, scales)
    got, mx, mn = pyramid_cuda.pyramid_forward(torch.from_numpy(boxes),
                                               scales)
    np.testing.assert_array_equal(_bits(got),
                                  _bits(_logical(c, dims, pack, scales)))
    _same_extrema(mx, jmx)
    _same_extrema(mn, jmn)


@pytest.mark.parametrize("dims,pack,scales", KERNEL_CASES)
def test_forward_hist_plain_matches_k6_interpret(dims, pack, scales):
    boxes = _batch(dims, 5, n=2 * pack)
    boxes[0, 0, 0, 0] = -0.0
    c = hp.fused_forward_interleaved_nored(
        jnp.asarray(_packed(boxes, pack)), pack, scales)
    want_hist = np.asarray(jthreshold.abs_exponent_histogram(c), np.int64)
    got, hist = pyramid_cuda.forward_hist(torch.from_numpy(boxes), scales)
    np.testing.assert_array_equal(_bits(got),
                                  _bits(_logical(c, dims, pack, scales)))
    assert hist.dtype == torch.int64 and tuple(hist.shape) == (2048,)
    np.testing.assert_array_equal(hist.numpy(), want_hist)


@pytest.mark.parametrize("dims,pack,scales", KERNEL_CASES)
def test_pyramid_inverse_plain_matches_k7_interpret(dims, pack, scales):
    boxes = _batch(dims, 6, n=2 * pack)
    c, _, _ = hp.fused_forward_interleaved(
        jnp.asarray(_packed(boxes, pack)), pack, scales)
    c = np.asarray(c)                    # the inverse donates its input
    want = np.asarray(hp.fused_inverse_interleaved(jnp.asarray(c), pack,
                                                   scales))
    logical = torch.from_numpy(_logical(c, dims, pack, scales))
    got = pyramid_cuda.pyramid_inverse(logical, scales).numpy()
    z = dims[2]
    for i in range(got.shape[0]):
        m, p = divmod(i, pack)
        np.testing.assert_array_equal(
            _bits(got[i]), _bits(want[m, :, :, p * z:(p + 1) * z]))


@pytest.mark.parametrize("dims", [(3, 33, 17), (8, 4, 2), (1, 1, 1),
                                  (16, 8, 8)])
def test_forward_hist_eff1_matches_jax_hist_step(dims):
    """At one scale (odd tails included) forward_hist is the JAX engine's
    fused ``_fwd_hist_step``: coefficients and uint32 histogram."""
    x = _batch(dims, 7, n=3)
    x[2] = 0.0
    flat, jhist = jengine._fwd_hist_step(jnp.asarray(x))
    got, hist = pyramid_cuda.forward_hist(torch.from_numpy(x), 1)
    np.testing.assert_array_equal(_bits(got).reshape(3, -1), _bits(flat))
    np.testing.assert_array_equal(hist.numpy(), np.asarray(jhist, np.int64))


# ---- abs_exponent_histogram -------------------------------------------

def _edge_values() -> np.ndarray:
    u32 = np.array([0x80000000,            # -0.0
                    0x7F800000, 0xFF800000,  # +-inf
                    0x7FC00000, 0xFFC00000,  # quiet NaN, sign-set quiet NaN
                    0x7FFFFFFF, 0xFFFFFFFF,  # all-ones NaN payloads
                    0x7F7FFFFF, 0x00800000,  # largest / smallest normal
                    0x3F800000, 0xBF800000],  # +-1
                   np.uint32)
    return np.concatenate([u32.view(np.float32), np.zeros(3, np.float32),
                           _batch((40,), 8, n=1).reshape(-1)])


def test_histogram_edge_keys_match_jax():
    v = _edge_values()
    got = threshold.abs_exponent_histogram(torch.from_numpy(v)).numpy()
    want = np.asarray(jthreshold.abs_exponent_histogram(jnp.asarray(v)))
    np.testing.assert_array_equal(got, want)
    assert got[0] == 4                    # three +0.0 and one -0.0
    assert got[2040] == 2                 # +-inf
    assert got[2044] == 2                 # quiet NaN, either sign
    assert got[2047] == 2 and got[0x7F7] >= 1  # NaNs, FLT_MAX


def test_histogram_subnormals_match_numpy_bincount():
    v = np.concatenate([_subnormal((50,), 9, n=1).reshape(-1),
                        _edge_values()])
    got = threshold.abs_exponent_histogram(torch.from_numpy(v)).numpy()
    keys = (v.view(np.uint32) & 0x7FFFFFFF) >> 20
    np.testing.assert_array_equal(got, np.bincount(keys, minlength=2048))
    assert got[:8].sum() > 0              # subnormal keys are 0..7


def test_histogram_of_subnormal_pyramid_matches_jax_under_its_flush():
    x = _subnormal((8, 8, 8), 10)
    c = jhaar.haar3d_forward_multi(jnp.asarray(x), 2)
    want = np.asarray(jthreshold.abs_exponent_histogram(c), np.int64)
    with _flush_denormal():
        _, hist = pyramid_cuda.forward_hist(torch.from_numpy(x), 2)
    np.testing.assert_array_equal(hist.numpy(), want)


# ---- threshold_from_histogram -----------------------------------------

@settings(max_examples=150, deadline=None)
@given(bins=st.dictionaries(st.integers(0, 2047),
                            st.integers(0, 1 << 40), max_size=12),
       keep_fraction=st.one_of(st.sampled_from([0.0, 1.0, 0.5, 0.29]),
                               st.floats(0.0, 1.0)))
def test_threshold_from_histogram_matches_jax(bins, keep_fraction):
    hist = np.zeros(2048, np.int64)
    for k, n in bins.items():
        hist[k] = n
    got = threshold.threshold_from_histogram(hist, keep_fraction)
    want = jthreshold.threshold_from_histogram(hist, keep_fraction)
    assert isinstance(got, np.float32)
    assert _bits(got) == _bits(want)


@pytest.mark.parametrize("bins,kf,want_bits", [
    ({}, 0.5, 0),                                  # empty -> 0.0
    ({0: 5, 1: 5}, 0.1, 0),                        # k <= 1 -> 0.0
    ({1000: 7}, 0.01, (1000 << 20) - 1),           # step down into a full bin
    ({1000: 7, 1200: 3}, 0.0, (1200 << 20) - 1),   # keep_fraction 0
    ({1000: 7, 1200: 3}, 1.0, 0),                  # keep_fraction 1
])
def test_threshold_from_histogram_corner_cases(bins, kf, want_bits):
    hist = np.zeros(2048, np.int64)
    for k, n in bins.items():
        hist[k] = n
    got = threshold.threshold_from_histogram(hist, kf)
    assert _bits(got) == _bits(jthreshold.threshold_from_histogram(hist, kf))
    assert int(_bits(got)[0]) == want_bits


# ---- wrappers and engine ----------------------------------------------

def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    before = dict(pyramid_cuda.launches)
    x = torch.from_numpy(_batch((8, 8, 8), 11))
    c, _, _ = pyramid_cuda.pyramid_forward(x, 2)
    pyramid_cuda.forward_hist(x, 2)
    pyramid_cuda.pyramid_inverse(c, 2)
    assert pyramid_cuda.launches == before


@pytest.mark.parametrize("fn", [pyramid_cuda.pyramid_forward,
                                pyramid_cuda.forward_hist,
                                pyramid_cuda.pyramid_inverse])
@pytest.mark.parametrize("bad,scales,err", [
    (torch.zeros((2, 8, 8, 8), dtype=torch.float64), 2, TypeError),
    (torch.zeros((8, 8, 8)), 2, ValueError),
    (torch.zeros((2, 8, 8, 16))[..., ::2], 2, ValueError),
    (torch.zeros((2, 8, 8, 8)), 0, ValueError),
    (torch.zeros((2, 8, 8, 8)), 4, ValueError),     # odd scale-3 corner
    (torch.zeros((2, 1, 8, 8)), 2, ValueError),     # empty scale-1 corner
])
def test_wrappers_reject_bad_input(fn, bad, scales, err):
    with pytest.raises(err):
        fn(bad, scales)


def test_eff_scales_match_jax():
    for scales in (1, 2, 3, 4):
        eng = engine.CodecEngine(device="cpu", scales=scales)
        jeng = jengine.CodecEngine(scales=scales)
        for dims in [(64, 64, 64), (32, 64, 64), (8, 4, 2), (16, 8, 8),
                     (9, 6, 4), (24, 24, 8)]:
            assert eng.eff_scales(dims) == jeng.eff_scales(dims), dims


@pytest.mark.parametrize("dims", [(16, 8, 8), (8, 4, 2), (9, 6, 4)])
def test_engine_pyramid_entry_points_match_jax(dims):
    """scales=2 engine entry points against the JAX engine's CPU path:
    coefficients, signed extrema, thresholds, histograms, inverse."""
    x = _batch(dims, 12, n=4)
    x[0] = 0.0
    x[0, 1, 0, 0] = 8.0                  # an exact min == -max tie
    eng = engine.CodecEngine(device="cpu", scales=2)
    jeng = jengine.CodecEngine(scales=2)
    flat, signed = eng.forward_signed_batch(x)
    jflat, jsigned = jeng.forward_signed_batch(x)
    np.testing.assert_array_equal(_bits(flat), _bits(jflat))
    np.testing.assert_array_equal(_bits(signed), _bits(jsigned))
    np.testing.assert_array_equal(
        _bits(eng.compress_batch_raw(x, 0.999)[1]),
        _bits(jeng.compress_batch_raw(x, 0.999)[1]))
    np.testing.assert_array_equal(
        _bits(eng.decompress_batch(flat, dims)),
        _bits(jeng.decompress_batch(jflat, dims)))
    hflat, hist = eng.forward_hist_batch(x, n_pad_rows=1)
    jhflat, jhist = jeng.forward_hist_batch(x, n_pad_rows=1)
    np.testing.assert_array_equal(_bits(hflat), _bits(jhflat))
    np.testing.assert_array_equal(hist, jhist)


@pytest.mark.parametrize("fetch", [True, False])
def test_forward_hist_shapebatch_matches_jax(fetch):
    """A padded batch: the padding rows leave the zero bin, and
    ``fetch_coeffs=False`` returns no coefficients."""
    dims = (16, 8, 8)
    items = [batching.WorkItem(t=0, level=0, comp_idx=0, box=b)
             for b in range(3)]
    data = np.zeros((5,) + dims, np.float32)
    data[:3] = _batch(dims, 13, n=3)
    outs = []
    for eng in (engine.CodecEngine(device="cpu", scales=2),
                jengine.CodecEngine(scales=2)):
        batch = batching.ShapeBatch(shape=dims, data=data.copy(),
                                    items=items, n_valid=3)
        outs.append(eng.forward_hist_shapebatch(batch, fetch_coeffs=fetch))
    (cb, hist), (jcb, jhist) = outs
    np.testing.assert_array_equal(hist, jhist)
    assert hist.sum() == 3 * 16 * 8 * 8
    if fetch:
        np.testing.assert_array_equal(_bits(cb.data), _bits(jcb.data))
        cb.scales = engine.CodecEngine(device="cpu",
                                       scales=2).eff_scales(dims)
        out = engine.CodecEngine(device="cpu",
                                 scales=2).decompress_shapebatch(cb)
        np.testing.assert_array_equal(
            _bits(out.data), _bits(jengine.CodecEngine(
                scales=2).decompress_shapebatch(jcb).data))
    else:
        assert cb is None and jcb is None
