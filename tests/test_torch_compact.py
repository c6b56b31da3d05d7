"""The port's compaction (``kernels/compact_cuda.compact``) against the JAX
package's, on the CPU.

The CUDA kernels ``compact_count``/``compact_scatter`` run only on the card
(tests/test_torch_cuda.py and chip_smoke.py hold them to the plain
version); here the plain version, which a CPU tensor takes, is held
bitwise to three JAX versions of the same function: ``engine._compact_step``
(the argsort reference), and ``compact_pallas.compact_fast`` with the Pallas
kernels K8 + K9 (``impl="pallas", assemble="pallas"``) and K10 + K9
(``impl="direct"``) in interpret mode.  Counts must be equal, and the
first ``count`` (index, value) pairs of every row a consumer reads must be
equal bit for bit: every row with ``count <= cap`` for the fast path (whose
rows past ``cap`` or with a per-chunk overflow are never read), and the
first ``min(count, cap)`` pairs of every row for the argsort reference.
"""

import numpy as np
import pytest

import jax.numpy as jnp

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from wavelet_tpu.kernels import compact_pallas  # noqa: E402
from wavelet_tpu.runtime import engine as jengine  # noqa: E402
from wavelet_tpu_torch.kernels import compact_cuda  # noqa: E402

# (m, cap): the fast path's row lengths (a power of two, a 64^3 box, a
# length that is not a multiple of 512 nor of the kernel's 4096 tile), and
# caps below some rows' counts
SHAPES = [(8192, 512), (64 ** 3, 5248), (13824, 517)]
NAN = np.float32(np.nan)
SUB = np.float32(1e-40)          # subnormal


def _case(m: int, kind: str):
    """-> (flat [n, m] f32, t32 [n] f32) from a numpy seed."""
    rng = np.random.default_rng(m + len(kind))
    n = 7
    flat = rng.standard_normal((n, m)).astype(np.float32)
    flat[rng.random((n, m)) < 0.01] *= 100          # ~1% above t = 5
    t32 = np.full(n, 5.0, np.float32)
    if kind == "random":
        # one row past the cap: ~10% kept
        flat[6, rng.random(m) < 0.1] = 50.0
        return flat, t32
    if kind == "special":
        # NaN is never kept; +-inf is kept below +inf
        flat[0, rng.choice(m, 40, replace=False)] = NAN
        flat[0, rng.choice(m, 20, replace=False)] = np.inf
        flat[0, rng.choice(m, 20, replace=False)] = -np.inf
        # a negative threshold keeps every non-NaN value, zeros included
        flat[1, : m // 2] = 0.0
        flat[1, 1: m // 2: 3] = -0.0
        flat[1, rng.choice(m, 10, replace=False)] = NAN
        t32[1] = -1.0
        # +inf keeps nothing, not even inf
        flat[2, rng.choice(m, 10, replace=False)] = np.inf
        t32[2] = np.inf
        # signed zeros against +0 and -0 thresholds: never kept
        flat[3] = 0.0
        flat[3, ::2] = -0.0
        flat[3, rng.choice(m, 30, replace=False)] = 7.0
        t32[3] = 0.0
        flat[4, ::5] = -0.0
        t32[4] = -0.0
        # a NaN threshold keeps nothing
        t32[5] = NAN
        return flat, t32
    if kind == "subnormal":
        # subnormal values and thresholds (compared flushed, as JAX on the
        # CPU does: see the fixture below)
        flat[0, rng.random(m) < 0.5] = SUB
        flat[1] = SUB * rng.standard_normal(m).astype(np.float32)
        t32[1] = np.float32(1e-41)
        flat[2, rng.random(m) < 0.02] = np.float32(3e-38)   # normal
        flat[2, rng.random(m) < 0.3] = -SUB
        t32[2] = np.float32(2e-38)
        t32[3] = SUB
        return flat, t32
    raise ValueError(kind)


@pytest.fixture
def flush_denormal():
    """JAX on the CPU flushes subnormals (ROADMAP C2); the torch side
    compares them flushed too for parity."""
    prev = torch.set_flush_denormal(True)
    assert prev is not None
    try:
        yield
    finally:
        torch.set_flush_denormal(False)


def _plain(flat, t32, cap):
    counts, idx, vals = compact_cuda.compact(
        torch.from_numpy(flat), torch.from_numpy(t32), cap)
    return counts.numpy(), idx.numpy(), vals.numpy()


def _jax(flat, t32, cap, ref):
    if ref == "argsort":
        out = jengine._compact_step(jnp.asarray(flat), jnp.asarray(t32), cap)
        return [np.asarray(x) for x in out] + [np.zeros(len(flat), bool)]
    impl = "pallas" if ref == "k8_k9" else "direct"
    out = compact_pallas.compact_fast(
        jnp.asarray(flat), jnp.asarray(t32), cap, impl=impl,
        assemble="pallas", interpret=True)
    return [np.asarray(x) for x in out]


def _assert_equal(got, want, cap, fast: bool, flat=None):
    """``flat`` given: rows holding +-inf compare indices only.  K9's
    matmul-gather (``compact_pallas._assemble_pallas``) multiplies every
    gathered value by a one-hot 0/1 matrix, and inf * 0 = NaN turns each
    kept value of such a row into NaN; the argsort reference and the
    port keep the values exact."""
    counts, idx, vals = got
    wcounts, widx, wvals, over = want
    np.testing.assert_array_equal(counts, wcounts)
    for i, c in enumerate(wcounts):
        if fast and (c > cap or over[i]):
            continue            # rows no consumer reads through pairs
        k = min(int(c), cap)
        np.testing.assert_array_equal(idx[i, :k], widx[i, :k], f"row {i}")
        if flat is not None and np.isinf(flat[i]).any():
            continue
        np.testing.assert_array_equal(vals[i, :k].view(np.int32),
                                      wvals[i, :k].view(np.int32),
                                      f"row {i}")


@pytest.mark.parametrize("ref", ["argsort", "k8_k9", "k10_k9"])
@pytest.mark.parametrize("kind", ["random", "special"])
@pytest.mark.parametrize("m,cap", SHAPES)
def test_plain_matches_jax(m, cap, kind, ref):
    flat, t32 = _case(m, kind)
    got = _plain(flat, t32, cap)
    fast = ref != "argsort"
    _assert_equal(got, _jax(flat, t32, cap, ref), cap, fast,
                  flat if fast else None)
    # the cases reach what they are meant to: some rows past the cap,
    # some rows below it with pairs to compare
    assert (got[0] > cap).any() and (got[0][got[0] <= cap] > 0).any()


@pytest.mark.parametrize("ref", ["argsort", "k8_k9", "k10_k9"])
@pytest.mark.parametrize("m,cap", SHAPES)
def test_plain_matches_jax_subnormal(flush_denormal, m, cap, ref):
    flat, t32 = _case(m, "subnormal")
    _assert_equal(_plain(flat, t32, cap), _jax(flat, t32, cap, ref), cap,
                  ref != "argsort")


@pytest.mark.parametrize("m", [1, 16, 64, 3 * 33 * 17 * 9])
def test_plain_matches_argsort_short_and_ragged_rows(m):
    """Rows shorter than one 4096-element tile, and a row that is not a
    multiple of it (the kernel's ragged edge), against the argsort path."""
    rng = np.random.default_rng(m)
    flat = (rng.standard_normal((5, m)) * 3).astype(np.float32)
    t32 = np.array([1.0, 0.5, -1.0, np.inf, 2.0], np.float32)
    cap = max(1, m // 2)
    _assert_equal(_plain(flat, t32, cap), _jax(flat, t32, cap, "argsort"),
                  cap, False)


def test_plain_exact_rules():
    """The keep rule on hand-made rows: |x| > t, NaN never kept, negative
    t keeps zeros, +inf keeps nothing; slots past the count are not
    read, the first ``cap`` pairs of an overflowing row are the row's
    first kept positions."""
    flat = torch.tensor([[0.0, -0.0, 3.0, float("nan"), -4.0, 1.0],
                         [0.0, -0.0, 3.0, float("nan"), -4.0, 1.0],
                         [float("inf"), 0.0, 3.0, 1.0, -4.0, 9.0]])
    t32 = torch.tensor([1.0, -1.0, float("inf")])
    counts, idx, vals = compact_cuda.compact(flat, t32, 3)
    assert counts.tolist() == [2, 5, 0]
    assert idx[0, :2].tolist() == [2, 4] and vals[0, :2].tolist() == [3, -4]
    assert idx[1].tolist() == [0, 1, 2]
    assert torch.equal(torch.signbit(vals[1, :2]),
                       torch.tensor([False, True]))


def test_compact_checks_inputs():
    flat = torch.zeros((2, 8))
    t32 = torch.zeros(2)
    for bad, err in (((flat.double(), t32, 4), TypeError),
                     ((flat, torch.zeros(3), 4), ValueError),
                     ((flat, t32, 0), ValueError),
                     ((flat, t32, 9), ValueError),
                     ((flat[:, ::2], t32, 2), ValueError),
                     ((torch.zeros((0, 8)), torch.zeros(0), 1), ValueError)):
        with pytest.raises(err):
            compact_cuda.compact(*bad)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    before = dict(compact_cuda.launches)
    flat = torch.ones((2, 8))
    compact_cuda.compact(flat, torch.zeros(2), 8)
    assert compact_cuda.launches == before
