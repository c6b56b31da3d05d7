"""The port's collective steps and device thresholds against the
JAX package.

``runtime/distributed``'s ``make_parity_compress_step``,
``make_global_compress_step`` (with ``kept_count``), ``make_train_step``
and ``make_sharded_box_forward`` / ``_inverse`` run over eight CPU
entries (``data_mesh(["cpu"] * 8)``) and must give bitwise what the JAX
package's ``shard_map`` programs give on the conftest's 8-device virtual
CPU mesh: coefficients, thresholds, kept counts and reconstructions; the
train step's RMSE to rtol 1e-6 (the port sums the squared error in
float64, JAX in float32 per shard).  ``core/threshold``'s
``threshold_from_histogram_device`` and ``global_histogram_threshold``
are held bin for bin to the host ``threshold_from_histogram`` and to
JAX's device versions, and ``CodecEngine.compress_batch``, ``shard_batch``
and the ``entry`` module to theirs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import __graft_entry__ as jentry  # noqa: E402
from wavelet_tpu.core import haar as jhaar  # noqa: E402
from wavelet_tpu.core import threshold as jthreshold  # noqa: E402
from wavelet_tpu.kernels import haar_pallas  # noqa: E402
from wavelet_tpu.runtime import distributed as jdist  # noqa: E402
from wavelet_tpu.runtime import engine as jengine  # noqa: E402
from wavelet_tpu.runtime import mesh as jmesh  # noqa: E402
from wavelet_tpu_torch import entry  # noqa: E402
from wavelet_tpu_torch.core import haar, threshold  # noqa: E402
from wavelet_tpu_torch.runtime import distributed, engine  # noqa: E402
from wavelet_tpu_torch.runtime import mesh as mesh_lib  # noqa: E402

CPU8 = mesh_lib.data_mesh(["cpu"] * 8)


@pytest.fixture(scope="module")
def mesh8():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs the conftest's 8 virtual devices")
    return jmesh.data_mesh(devs[:8])


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _eq(a, b) -> None:
    np.testing.assert_array_equal(_bits(a), _bits(b))


# ---- steps over a mesh ------------------------------------------------------

def test_parity_step_matches_jax(mesh8):
    batch = np.random.default_rng(0).standard_normal(
        (16, 8, 8, 8)).astype(np.float32)
    flat, signed = distributed.make_parity_compress_step(CPU8)(batch)
    jflat, jsigned = jdist.make_parity_compress_step(mesh8)(
        jmesh.shard_batch(batch, mesh8))
    assert flat.shape == (16, 512)
    _eq(flat, jflat)
    _eq(signed, jsigned)


@pytest.mark.parametrize("n_real,n_pad_rows", [(8, 0), (10, 6)])
def test_global_step_matches_jax(mesh8, n_real, n_pad_rows):
    rng = np.random.default_rng(1)
    batch = np.zeros((n_real + n_pad_rows, 4, 4, 4), np.float32)
    batch[:n_real] = rng.standard_normal((n_real, 4, 4, 4))
    masked, thr, kept = distributed.make_global_compress_step(
        CPU8, 0.1, n_pad_rows)(batch)
    jmasked, jthr, jkept = jdist.make_global_compress_step(
        mesh8, 0.1, n_pad_rows)(jmesh.shard_batch(batch, mesh8))
    _eq(masked, jmasked)
    _eq(thr, jthr)
    np.testing.assert_array_equal(kept, np.asarray(jkept))
    n = distributed.kept_count(kept)
    assert n == jdist.kept_count(jkept) == int(np.count_nonzero(masked))
    assert 0.05 < n / (n_real * 64) < 0.2


def test_global_step_threshold_is_the_unsharded_one():
    batch = np.random.default_rng(9).standard_normal(
        (8, 4, 4, 4)).astype(np.float32)
    _, thr, _ = distributed.make_global_compress_step(CPU8, 0.1)(batch)
    flat = haar.forward_flat(torch.from_numpy(batch))
    _eq(thr, threshold.global_histogram_threshold(flat, 0.1))
    _eq(thr, threshold.threshold_from_histogram(
        threshold.abs_exponent_histogram(flat).numpy(), 0.1))


def test_train_step_matches_jax(mesh8):
    batch = np.random.default_rng(2).standard_normal(
        (16, 4, 4, 8)).astype(np.float32)
    recon, thr, rmse = distributed.make_train_step(CPU8, 0.25)(batch)
    jrecon, jthr, jrmse = jdist.make_train_step(mesh8, 0.25)(
        jmesh.shard_batch(batch, mesh8))
    assert recon.shape == batch.shape
    _eq(recon, jrecon)
    _eq(thr, jthr)
    assert np.isfinite(rmse) and rmse > 0
    np.testing.assert_allclose(rmse, float(jrmse), rtol=1e-6)
    # on one entry the same step
    one = distributed.make_train_step(mesh_lib.data_mesh(["cpu"]), 0.25)
    orecon, othr, ormse = one(batch)
    _eq(orecon, recon)
    _eq(othr, thr)
    np.testing.assert_allclose(ormse, rmse, rtol=1e-12)


def test_sharded_box_forward_matches_jax(mesh8):
    box = (np.random.default_rng(7).standard_normal((32, 8, 16))
           * 10).astype(np.float32)
    got = distributed.make_sharded_box_forward(CPU8)(box)
    want = jdist.make_sharded_box_forward(mesh8)(
        jmesh.shard_batch(box, mesh8))
    _eq(got, want)
    _eq(got, jhaar.haar3d_forward(jnp.asarray(box)))


def test_sharded_box_roundtrip_matches_jax(mesh8):
    box = (np.random.default_rng(8).standard_normal((16, 4, 8))
           * 5).astype(np.float32)
    back = distributed.make_sharded_box_inverse(CPU8)(
        distributed.make_sharded_box_forward(CPU8)(box))
    jfwd = jdist.make_sharded_box_forward(mesh8)
    jback = jdist.make_sharded_box_inverse(mesh8)(
        jfwd(jmesh.shard_batch(box, mesh8)))
    _eq(back, jback)
    _eq(back, jhaar.haar3d_inverse(jhaar.haar3d_forward(jnp.asarray(box))))


def test_sharded_box_steps_refuse_what_jax_refuses():
    with pytest.raises(ValueError, match="even number"):
        distributed.make_sharded_box_forward(mesh_lib.data_mesh(["cpu"] * 3))
    with pytest.raises(ValueError, match="even number"):
        distributed.make_sharded_box_inverse(mesh_lib.data_mesh(["cpu"] * 3))
    box = np.zeros((24, 4, 4), np.float32)      # 3 rows per entry
    with pytest.raises(ValueError, match="must divide by 2"):
        distributed.make_sharded_box_forward(CPU8)(box)
    with pytest.raises(ValueError, match="must divide by 4"):
        distributed.make_sharded_box_forward_interleaved(CPU8, 2)(
            np.zeros((16, 4, 4), np.float32))


@pytest.mark.parametrize("scales", [1, 2])
def test_interleaved_steps_round_trip_like_jax(mesh8, scales):
    box = (np.random.default_rng(10 + scales).standard_normal((32, 8, 16))
           * 3).astype(np.float32)
    coeffs = distributed.make_sharded_box_forward_interleaved(
        CPU8, scales)(box)
    _eq(coeffs, haar.haar3d_forward_multi(torch.from_numpy(box[None]),
                                          scales)[0])
    back = distributed.make_sharded_box_inverse_interleaved(
        CPU8, scales)(coeffs)
    jc = jdist.make_sharded_box_forward_interleaved(mesh8, scales)(
        jmesh.shard_batch(box, mesh8))
    jback = jdist.make_sharded_box_inverse_interleaved(mesh8, scales)(jc)
    _eq(back, jback)
    _eq(back, haar_pallas._inv_interleaved_block(
        haar_pallas._fwd_interleaved_block(jnp.asarray(box), scales),
        scales))


# ---- the engine, shard_batch, the entry module ----------------------------

def test_compress_batch_matches_jax(mesh8):
    data = np.random.default_rng(3).standard_normal(
        (16, 8, 8, 8)).astype(np.float32)
    outs = []
    for eng in (engine.CodecEngine(device="cpu"),
                engine.CodecEngine(device="cpu", mesh=CPU8),
                jengine.CodecEngine(mesh=None),
                jengine.CodecEngine(mesh=mesh8)):
        flat, mask = eng.compress_batch(data, 0.999)
        outs.append((flat, mask, eng.decompress_batch(flat * mask,
                                                      (8, 8, 8))))
    for got in outs[1:]:
        _eq(got[0], outs[0][0])
        np.testing.assert_array_equal(got[1], outs[0][1])
        _eq(got[2], outs[0][2])
    assert outs[0][1].dtype == bool and outs[0][1].any()


def test_padded_rows_keep_nothing():
    b = np.zeros((8, 4, 4, 4), np.float32)
    b[:3] = np.arange(1, 4, dtype=np.float32)[:, None, None, None]
    _, mask = engine.CodecEngine(device="cpu", mesh=CPU8).compress_batch(
        b, 0.999)
    assert not mask[3:].any()


def test_mask_coefficients_matches_jax():
    rng = np.random.default_rng(4)
    c = rng.standard_normal((6, 40)).astype(np.float32)
    c[0, :3] = (np.nan, np.inf, -0.0)
    t32 = np.array([0.5, -0.1, 0.0, np.inf, np.nan, 1.0], np.float32)
    got = threshold.mask_coefficients(torch.from_numpy(c),
                                      torch.from_numpy(t32)).numpy()
    want = np.asarray(jthreshold.mask_coefficients(jnp.asarray(c),
                                                   jnp.asarray(t32)))
    np.testing.assert_array_equal(got, want)


def test_shard_batch_gives_each_entry_its_rows():
    x = np.arange(16 * 2, dtype=np.float32).reshape(16, 2)
    chunks = mesh_lib.shard_batch(x, CPU8)
    assert [c.shape[0] for c in chunks] == [2] * 8
    np.testing.assert_array_equal(torch.cat(chunks).numpy(), x)
    assert all(c.device == torch.device("cpu") for c in chunks)
    # a batch the mesh does not divide stays whole on the first entry
    [whole] = mesh_lib.shard_batch(x[:5], CPU8)
    np.testing.assert_array_equal(whole.numpy(), x[:5])
    # process 1 of 2 with two entries each: global entries 2 and 3
    gm = mesh_lib.GlobalMesh(mesh_lib.data_mesh(["cpu"] * 2), 2, 1)
    assert (gm.size, gm.offset, gm.spans_processes) == (4, 2, True)
    assert mesh_lib.batch_sharding(16, gm) == [
        (torch.device("cpu"), 8, 12), (torch.device("cpu"), 12, 16)]
    np.testing.assert_array_equal(
        torch.cat(mesh_lib.shard_batch(x, gm)).numpy(), x[8:])
    with pytest.raises(ValueError, match="do not split"):
        mesh_lib.batch_sharding(6, gm)


def test_shard_batch_without_a_mesh_asks_for_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        mesh_lib.shard_batch(np.zeros((2, 2), np.float32))
    [c] = mesh_lib.shard_batch(np.zeros((2, 2), np.float32), device="cpu")
    assert c.device == torch.device("cpu")


def test_entry_matches_jax():
    fn, args = entry.entry(device="cpu")
    flat, signed = fn(*args)
    jfn, jargs = jentry.entry()
    jflat, jsigned = jax.jit(jfn)(*jargs)
    np.testing.assert_array_equal(args[0], np.asarray(jargs[0]))
    assert flat.shape == (8, 16 * 32 * 64) and signed.shape == (8,)
    _eq(flat, jflat)
    _eq(signed, jsigned)


@pytest.mark.parametrize("n", [2, 8])
def test_dryrun_multichip_runs_on_cpu_entries(n):
    out = entry.dryrun_multichip(n, device="cpu")
    assert out["threshold"] >= 0 and np.isfinite(out["rmse"])


def test_entry_points_ask_for_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        entry.entry()
    with pytest.raises(RuntimeError, match="cuda"):
        entry.dryrun_multichip(2)


# ---- device thresholds ------------------------------------------------------

def test_global_histogram_threshold_matches_jax():
    mags = np.random.default_rng(0).uniform(0, 1, 1 << 16).astype(
        np.float32)
    thr = threshold.global_histogram_threshold(torch.from_numpy(mags), 0.1)
    _eq(thr, jthreshold.global_histogram_threshold(jnp.asarray(mags), 0.1))
    assert np.mean(np.abs(mags) > float(thr)) <= 0.1 + 1e-12
    # per-entry chunks sum like the whole
    chunks = list(torch.from_numpy(mags).chunk(8))
    _eq(threshold.global_histogram_threshold(chunks, 0.1), thr)


def test_device_threshold_matches_host_and_jax():
    rng = np.random.default_rng(7)
    cases = [(rng.standard_normal(4096).astype(np.float32) * 100, kf)
             for kf in (0.5, 0.1, 0.02, 0.001)]
    cases += [(np.full(512, 3.0, np.float32), 0.01),
              (np.zeros(512, np.float32), 0.01)]
    for data, kf in cases:
        hist = threshold.abs_exponent_histogram(torch.from_numpy(data))
        t_host = threshold.threshold_from_histogram(hist.numpy(), kf)
        t_dev = threshold.threshold_from_histogram_device(hist, kf, data.size)
        t_jax = jthreshold.threshold_from_histogram_device(
            jthreshold.abs_exponent_histogram(jnp.asarray(data)), kf,
            data.size)
        assert t_dev.dtype == torch.float32 and t_dev.dim() == 0
        _eq(t_dev, t_host)
        _eq(t_dev, t_jax)


@pytest.mark.parametrize("kf,total,top", [(0.29, 100, 29), (0.57, 100, 57),
                                          (0.57, 300, 171), (0.5, 58, 29)])
def test_device_threshold_integer_boundary_matches_host(kf, total, top):
    """keep_fraction * total just below an integer: the device compare
    floors like the host's integer-against-f64 compare."""
    hist = np.zeros(threshold.EXP_HIST_BINS, np.int64)
    hist[100] = total - top
    hist[200] = top
    t_host = threshold.threshold_from_histogram(hist, kf)
    t_dev = threshold.threshold_from_histogram_device(
        torch.from_numpy(hist), kf, total)
    t_jax = jthreshold.threshold_from_histogram_device(
        jnp.asarray(hist.astype(np.uint32)), kf, total)
    _eq(t_dev, t_host)
    _eq(t_dev, t_jax)


@settings(max_examples=150, deadline=None)
@given(bins=st.dictionaries(st.integers(0, 2047),
                            st.integers(1 << 24, 1 << 40), min_size=1,
                            max_size=12),
       keep_fraction=st.one_of(st.sampled_from([0.0, 1.0, 0.5, 0.29]),
                               st.floats(0.0, 1.0)),
       pad=st.integers(0, 1 << 24))
def test_device_threshold_is_exact_above_2_to_the_24(bins, keep_fraction,
                                                     pad):
    """Totals past float32's exact integers: the port's int64 counts
    select the host's bin (JAX's float32 cumulative sum need not)."""
    hist = np.zeros(threshold.EXP_HIST_BINS, np.int64)
    for k, n in bins.items():
        hist[k] = n
    total = int(hist.sum())
    assert total >= 1 << 24
    t_host = threshold.threshold_from_histogram(hist, keep_fraction)
    t_dev = threshold.threshold_from_histogram_device(
        torch.from_numpy(hist), keep_fraction, total)
    _eq(t_dev, t_host)
    # padding zeros leave bin 0 after the sum, as the host pipeline's
    padded = hist.copy()
    padded[0] += pad
    t_pad = threshold.threshold_from_histogram_device(
        torch.from_numpy(padded), keep_fraction, total, pad_zeros=pad)
    _eq(t_pad, t_host)
