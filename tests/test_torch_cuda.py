"""The CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU and carries the ``cuda`` marker; on a
machine without CUDA each one skips.  The file imports no jax, so it also
runs on the GPU machine, where jax is not installed (tests/conftest.py
imports jax, so skip it there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from wavelet_tpu_torch.runtime import batching  # noqa: E402
from wavelet_tpu_torch.kernels import (compact_cuda, haar_cuda,  # noqa: E402
                                       packed_cuda, pyramid_cuda)
from wavelet_tpu_torch.runtime import engine  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _bits(t) -> np.ndarray:
    return t.detach().cpu().numpy().view(np.int32)


def _batch(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 50).astype(np.float32)


@pytest.mark.parametrize("shape", [(32, 64, 64, 64), (3, 33, 17, 9),
                                   (2, 1, 1, 1), (5, 8, 4, 2),
                                   (70000, 2, 2, 2), (4096, 8, 4, 2),
                                   (300, 8, 8, 8), (3, 1, 2, 3)])
def test_kernels_match_plain(cuda_device, shape):
    x = torch.from_numpy(_batch(shape, 0)).to(cuda_device)
    c, mx, mn = haar_cuda.fused_forward(x)
    pc, pmx, pmn = haar_cuda.fused_forward_plain(x)
    np.testing.assert_array_equal(_bits(c), _bits(pc))
    # nonzero random data: no zero extremum, so the extrema are bitwise too
    np.testing.assert_array_equal(_bits(mx), _bits(pmx))
    np.testing.assert_array_equal(_bits(mn), _bits(pmn))
    np.testing.assert_array_equal(_bits(haar_cuda.fused_inverse(c)),
                                  _bits(haar_cuda.fused_inverse_plain(c)))


def test_cuda_tensors_launch_and_count(cuda_device):
    before = dict(haar_cuda.launches)
    x = torch.from_numpy(_batch((2, 8, 4, 2), 1)).to(cuda_device)
    haar_cuda.fused_inverse(haar_cuda.fused_forward(x)[0])
    assert haar_cuda.launches["haar_forward"] == before["haar_forward"] + 1
    assert haar_cuda.launches["haar_inverse"] == before["haar_inverse"] + 1


def test_engine_cuda_equals_cpu(cuda_device):
    dims = (9, 6, 4)
    items = [batching.WorkItem(t=0, level=0, comp_idx=0, box=b)
             for b in range(5)]
    data = _batch((5,) + dims, 2)
    outs = []
    for dev in ("cuda", "cpu"):
        eng = engine.CodecEngine(device=dev)
        batch = batching.ShapeBatch(shape=dims, data=data.copy(),
                                    items=items, n_valid=5)
        cb, t32 = eng.compress_shapebatch(batch, 0.999)
        outs.append((cb.data, t32, eng.decompress_shapebatch(cb).data))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


@pytest.mark.parametrize("shape,scales", [((8, 64, 64, 64), 2),
                                          ((4, 32, 64, 64), 3),
                                          ((6, 8, 8, 8), 3),
                                          ((3, 16, 8, 8), 1)])
def test_pyramid_kernels_match_plain(cuda_device, shape, scales):
    x = torch.from_numpy(_batch(shape, 3)).to(cuda_device)
    c, mx, mn = pyramid_cuda.pyramid_forward(x, scales)
    pc, pmx, pmn = pyramid_cuda.pyramid_forward_plain(x, scales)
    np.testing.assert_array_equal(_bits(c), _bits(pc))
    np.testing.assert_array_equal(_bits(mx), _bits(pmx))
    np.testing.assert_array_equal(_bits(mn), _bits(pmn))
    hc, hist = pyramid_cuda.forward_hist(x, scales)
    np.testing.assert_array_equal(_bits(hc), _bits(pc))
    np.testing.assert_array_equal(
        hist.cpu().numpy(),
        pyramid_cuda.forward_hist_plain(x, scales)[1].cpu().numpy())
    np.testing.assert_array_equal(
        _bits(pyramid_cuda.pyramid_inverse(c, scales)),
        _bits(pyramid_cuda.pyramid_inverse_plain(c, scales)))


@pytest.mark.parametrize("shape", [(3, 33, 17, 9), (5, 8, 4, 2),
                                   (2, 1, 1, 1)])
def test_forward_hist_odd_shapes_match_plain(cuda_device, shape):
    x = torch.from_numpy(_batch(shape, 4)).to(cuda_device)
    c, hist = pyramid_cuda.forward_hist(x, 1)
    pc, phist = pyramid_cuda.forward_hist_plain(x, 1)
    np.testing.assert_array_equal(_bits(c), _bits(pc))
    np.testing.assert_array_equal(hist.cpu().numpy(), phist.cpu().numpy())


def test_pyramid_launches_count(cuda_device):
    before = dict(pyramid_cuda.launches)
    x = torch.from_numpy(_batch((2, 8, 8, 8), 5)).to(cuda_device)
    c, _, _ = pyramid_cuda.pyramid_forward(x, 2)
    pyramid_cuda.forward_hist(x, 2)
    pyramid_cuda.pyramid_inverse(c, 2)
    for k in ("pyramid_forward", "forward_hist", "pyramid_inverse"):
        assert pyramid_cuda.launches[k] == before[k] + 1


@pytest.mark.parametrize("scales", [2, 3])
def test_engine_scales_cuda_equals_cpu(cuda_device, scales):
    dims = (16, 8, 8)
    items = [batching.WorkItem(t=0, level=0, comp_idx=0, box=b)
             for b in range(5)]
    data = np.zeros((6,) + dims, np.float32)
    data[:5] = _batch((5,) + dims, 6)
    outs = []
    for dev in ("cuda", "cpu"):
        eng = engine.CodecEngine(device=dev, scales=scales)
        batch = batching.ShapeBatch(shape=dims, data=data.copy(),
                                    items=items, n_valid=5)
        cb, t32 = eng.compress_shapebatch(batch, 0.999)
        hb, hist = eng.forward_hist_shapebatch(batch)
        outs.append((cb.data, t32, hb.data, hist,
                     eng.decompress_shapebatch(cb).data))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def _compact_rows(m, seed, cap):
    """Rows at ~1% kept, ~10% kept (past the cap), with NaN and +-inf,
    zeros and signed zeros under negative and +-0 thresholds (-1 keeps
    the whole row), subnormals, thresholds +inf and NaN, and a row whose
    kept prefix reaches ``cap`` at a tile boundary."""
    rng = np.random.default_rng(seed)
    n = 10
    flat = rng.standard_normal((n, m)).astype(np.float32)
    flat[rng.random((n, m)) < 0.01] *= 100
    t32 = np.full(n, 5.0, np.float32)
    flat[1, rng.random(m) < 0.1] = 50.0
    flat[2, rng.random(m) < 0.01] = np.nan
    flat[2, rng.random(m) < 0.01] = np.inf
    flat[2, rng.random(m) < 0.01] = -np.inf
    flat[3, ::2] = 0.0
    flat[3, 1::4] = -0.0
    t32[3] = -1.0
    flat[4, ::3] = -0.0
    t32[4] = -0.0
    flat[5] = (rng.standard_normal(m) * 1e-40).astype(np.float32)
    t32[5] = np.float32(1e-41)
    t32[6] = np.inf
    t32[7] = np.nan
    flat[8] = 0.0
    t32[8] = 0.0
    # the kept prefix reaches the cap exactly at the end of the kernel's
    # first 8192-element tile, and more is kept after it
    first = min(m, 8192)
    flat[9] = 0.0
    flat[9, rng.choice(first, min(cap, first), replace=False)] = 50.0
    flat[9, first:][rng.random(m - first) < 0.05] = -50.0
    return flat, t32


def _assert_compact_equal(got, want, cap):
    counts, idx, vals = (x.cpu().numpy() for x in got)
    wcounts, widx, wvals = (x.cpu().numpy() for x in want)
    np.testing.assert_array_equal(counts, wcounts)
    for i, c in enumerate(wcounts):
        k = min(int(c), cap)
        np.testing.assert_array_equal(idx[i, :k], widx[i, :k])
        np.testing.assert_array_equal(vals[i, :k].view(np.int32),
                                      wvals[i, :k].view(np.int32))


@pytest.mark.parametrize("m,cap", [(1, 1), (16, 8), (64, 64), (4096, 300),
                                   (13824, 517), (3 * 33 * 17 * 9, 2000),
                                   (64 ** 3, 5248), (4093, 517), (4094, 517),
                                   (8191, 517), (8192, 517), (8193, 517),
                                   (16387, 517)])
def test_compact_kernels_match_plain(cuda_device, m, cap):
    """Row lengths at the kernel's 8192-element tile edges (8191, 8192,
    8193, 16387) and 1, 2, 3 mod 4 (its scalar loads) among the others."""
    flat, t32 = _compact_rows(m, m, cap)
    flat = torch.from_numpy(flat).to(cuda_device)
    t32 = torch.from_numpy(t32).to(cuda_device)
    got = compact_cuda.compact(flat, t32, cap)
    want = compact_cuda.compact_plain(flat, t32, cap)
    torch.cuda.synchronize()
    _assert_compact_equal(got, want, cap)


def test_compact_many_short_rows(cuda_device):
    """70,000 rows, more than a grid dimension's 65,535, of 64 elements."""
    rng = np.random.default_rng(70000)
    n, m, cap = 70000, 64, 16
    flat = torch.from_numpy(rng.standard_normal((n, m), np.float32)).to(
        cuda_device)
    t32 = rng.uniform(0.0, 3.0, n).astype(np.float32)
    t32[::7] = -1.0
    t32 = torch.from_numpy(t32).to(cuda_device)
    got = compact_cuda.compact(flat, t32, cap)
    want = compact_cuda.compact_plain(flat, t32, cap)
    torch.cuda.synchronize()
    _assert_compact_equal(got, want, cap)


def test_compact_launches_count(cuda_device):
    assert set(compact_cuda.launches) == {"compact"}
    before = compact_cuda.launches["compact"]
    flat = torch.ones((2, 8), device=cuda_device)
    compact_cuda.compact(flat, torch.zeros(2, device=cuda_device), 8)
    assert compact_cuda.launches["compact"] == before + 1


@pytest.mark.parametrize("dims,scales", [((16, 16, 16), 1),
                                         ((16, 16, 16), 2), ((9, 6, 5), 1)])
def test_engine_sparse_cuda_equals_cpu(cuda_device, dims, scales, tmp_path):
    items = [batching.WorkItem(t=0, level=0, comp_idx=0, box=b)
             for b in range(5)]
    data = _batch((5,) + dims, 7)
    data[:, 1:, :, :] *= 1e-4
    outs = []
    for dev in ("cuda", "cpu"):
        eng = engine.CodecEngine(device=dev, scales=scales)
        batch = batching.ShapeBatch(shape=dims, data=data.copy(),
                                    items=items, n_valid=5)
        sparse, t32 = eng.compress_shapebatch_sparse(batch, 0.999)
        pairs = [sparse.item_pairs(i, float(t32[i])) for i in range(5)]
        packer = engine.HostPacker()
        out_dir = tmp_path / dev
        out_dir.mkdir()
        packer.pack_sparse(str(out_dir), sparse, t32)
        shell = batching.ShapeBatch(shape=dims, data=None, items=items,
                                    n_valid=5)
        idx, vals = packer.unpack_sparse(str(out_dir), shell)
        rec = eng.decompress_shapebatch_sparse(shell, idx, vals).data
        outs.append((t32, sparse.counts, pairs, rec))
    (t, c, p, r), (ct, cc, cp, cr) = outs
    np.testing.assert_array_equal(t.view(np.int32), ct.view(np.int32))
    np.testing.assert_array_equal(c, cc)
    for (a, b), (ca, cb) in zip(p, cp):
        np.testing.assert_array_equal(a, ca)
        np.testing.assert_array_equal(b.view(np.int32), cb.view(np.int32))
    np.testing.assert_array_equal(r.view(np.int32), cr.view(np.int32))


def _packed_rows(dims, pack, rows, seed):
    x, y, z = dims
    b = _batch((pack * rows,) + tuple(dims), seed)
    return np.ascontiguousarray(
        b.reshape(rows, pack, x, y, z).transpose(0, 2, 3, 1, 4)
        .reshape(rows, x, y, pack * z))


@pytest.mark.parametrize("dims,pack,rows", [((64, 64, 64), 2, 2),
                                            ((32, 64, 64), 2, 3),
                                            ((8, 4, 2), 64, 2),
                                            ((5, 3, 16), 8, 2),
                                            ((3, 3, 6), 2, 3)])
def test_packed_kernels_match_plain(cuda_device, dims, pack, rows):
    x = torch.from_numpy(_packed_rows(dims, pack, rows, 8)).to(cuda_device)
    c, mx, mn = packed_cuda.packed_forward(x, pack)
    pc, pmx, pmn = packed_cuda.packed_forward_plain(x, pack)
    np.testing.assert_array_equal(_bits(c), _bits(pc))
    np.testing.assert_array_equal(_bits(mx), _bits(pmx))
    np.testing.assert_array_equal(_bits(mn), _bits(pmn))
    hc, hist = packed_cuda.packed_forward_hist(x, pack)
    np.testing.assert_array_equal(_bits(hc), _bits(pc))
    np.testing.assert_array_equal(
        hist.cpu().numpy(),
        packed_cuda.packed_forward_hist_plain(x, pack)[1].cpu().numpy())
    for coeffs in (c, x):
        np.testing.assert_array_equal(
            _bits(packed_cuda.packed_inverse(coeffs, pack)),
            _bits(packed_cuda.packed_inverse_plain(coeffs, pack)))


def test_packed_launches_count(cuda_device):
    before = dict(packed_cuda.launches)
    x = torch.from_numpy(_packed_rows((4, 4, 16), 8, 1, 9)).to(cuda_device)
    c, _, _ = packed_cuda.packed_forward(x, 8)
    packed_cuda.packed_forward_hist(x, 8)
    packed_cuda.packed_inverse(c, 8)
    for k in ("packed_forward", "packed_forward_hist", "packed_inverse"):
        assert packed_cuda.launches[k] == before[k] + 1


@pytest.mark.parametrize("dims,n", [((4, 8, 16), 5), ((8, 4, 2), 3),
                                    ((5, 3, 16), 9)])
def test_engine_halves_cuda_equals_cpu(cuda_device, dims, n):
    items = [batching.WorkItem(t=0, level=0, comp_idx=0, box=b)
             for b in range(n)]
    data = _batch((n,) + dims, 10)
    outs = []
    for dev in ("cuda", "cpu"):
        eng = engine.CodecEngine(device=dev, layout="halves")
        [batch] = batching.plan_batches(
            [(it, data[i]) for i, it in enumerate(items)],
            pack_fn=eng.pack_factor)
        assert batch.pack > 1
        cb, t32 = eng.compress_shapebatch(batch, 0.999)
        hb, hist = eng.forward_hist_shapebatch(batch)
        sparse, st32 = eng.compress_shapebatch_sparse(batch, 0.999)
        outs.append((cb.data, t32, hb.data, hist, sparse.counts, st32,
                     eng.decompress_shapebatch(cb).data))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(np.asarray(a).view(np.int32),
                                      np.asarray(b).view(np.int32))


def test_rmse_batch_cuda_close_to_cpu(cuda_device):
    a = _batch((3, 64, 32, 5), 11)
    b = (a + _batch((3, 64, 32, 5), 12) * 1e-5).astype(np.float32)
    got = engine.CodecEngine(device="cuda").rmse_batch(a, b)
    want = engine.CodecEngine(device="cpu").rmse_batch(a, b)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _coeff_batch(dims, scales, n, seed):
    """A logical-order coefficient batch of ``n`` random boxes' pyramids."""
    from wavelet_tpu_torch.core import haar

    x = torch.from_numpy(_batch((n,) + dims, seed))
    items = [batching.WorkItem(t=0, level=0, comp_idx=0, box=b)
             for b in range(n)]
    return batching.ShapeBatch(
        shape=dims, data=haar.haar3d_forward_multi(x, scales).numpy(),
        items=items, n_valid=n, layout="halves", scales=scales)


@pytest.mark.parametrize("scales,depth", [(1, 1), (1, 2), (2, 1), (2, 2),
                                          (3, 1), (2, 3)])
def test_preview_cuda_equals_cpu(cuda_device, scales, depth):
    batch = _coeff_batch((16, 8, 8), scales, 4, 13)
    got, h2d = engine.CodecEngine(device="cuda", scales=scales) \
        .preview_shapebatch(batch, depth)
    want, want_h2d = engine.CodecEngine(device="cpu", scales=scales) \
        .preview_shapebatch(batch, depth)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert h2d == want_h2d and (h2d == 0) == (depth == scales)


def test_lowpass_on_the_card_equals_cpu(cuda_device):
    from wavelet_tpu_torch.core import haar

    x = torch.from_numpy(_batch((3, 16, 8, 24), 14))
    for depth in (1, 2, 3):
        np.testing.assert_array_equal(
            _bits(haar.haar3d_lowpass(x.to(cuda_device), depth)),
            _bits(haar.haar3d_lowpass(x, depth)))


def _mesh2():
    from wavelet_tpu_torch.runtime import mesh as mesh_lib

    n = 2 if torch.cuda.device_count() >= 2 else 1
    return mesh_lib.data_mesh([f"cuda:{i % n}" for i in range(2)])


@pytest.mark.parametrize("dims,scales", [((16, 16, 16), 1), ((16, 8, 8), 2),
                                         ((9, 6, 5), 1)])
def test_two_entry_mesh_cuda_equals_cpu(cuda_device, dims, scales):
    data = _batch((6,) + dims, 15)
    data[:, 1:] *= 1e-4
    items = [batching.WorkItem(t=0, level=0, comp_idx=0, box=b)
             for b in range(5)]
    outs = []
    for eng in (engine.CodecEngine(device="cuda", scales=scales,
                                   mesh=_mesh2()),
                engine.CodecEngine(device="cpu", scales=scales)):
        batch = batching.ShapeBatch(shape=dims, data=data.copy(),
                                    items=items, n_valid=5)
        before = dict(haar_cuda.launches)
        cb, t32 = eng.compress_shapebatch(batch, 0.999)
        if eng.device.type == "cuda" and scales == 1:
            # one launch per row chunk
            assert haar_cuda.launches["haar_forward"] == \
                before["haar_forward"] + 2
        hb, hist = eng.forward_hist_shapebatch(batch)
        sparse, st32 = eng.compress_shapebatch_sparse(batch, 0.999)
        outs.append((cb.data, t32, hb.data, hist, sparse.counts[:5], st32,
                     eng.decompress_shapebatch(cb).data))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(np.asarray(a).view(np.int32),
                                      np.asarray(b).view(np.int32))


@pytest.mark.parametrize("scales", [1, 2])
def test_giant_box_over_two_entries_equals_unsplit(cuda_device, scales):
    dims = (64, 32, 32)
    data = _batch((1,) + dims, 16)
    items = [batching.WorkItem(t=0, level=0, comp_idx=0, box=0)]
    giant = engine.CodecEngine(device="cuda", scales=scales, mesh=_mesh2(),
                               giant_box_bytes=1 << 17)
    plain = engine.CodecEngine(device="cpu", scales=scales)
    assert giant.giant_ok(dims)
    outs = []
    for eng in (giant, plain):
        batch = batching.ShapeBatch(shape=dims, data=data.copy(),
                                    items=items, n_valid=1)
        before = {**haar_cuda.launches, **pyramid_cuda.launches}
        cb, t32 = eng.compress_shapebatch(batch, 0.999)
        if eng is giant:
            fwd = "haar_forward" if scales == 1 else "pyramid_forward"
            after = {**haar_cuda.launches, **pyramid_cuda.launches}
            assert after[fwd] == before[fwd] + 2      # one per X-slab
        hb, hist = eng.forward_hist_shapebatch(batch)
        outs.append((cb.data, t32, hb.data, hist,
                     eng.decompress_shapebatch(cb).data))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(np.asarray(a).view(np.int32),
                                      np.asarray(b).view(np.int32))


@pytest.mark.parametrize("kf", [0.5, 0.02, 0.001])
def test_device_threshold_on_the_card_equals_host(cuda_device, kf):
    from wavelet_tpu_torch.core import threshold

    x = torch.from_numpy(_batch((4, 16, 16, 16), 17)).to(cuda_device)
    hist = threshold.abs_exponent_histogram(x)
    t = threshold.threshold_from_histogram_device(hist, kf, x.numel())
    assert t.device == x.device
    want = threshold.threshold_from_histogram(hist.cpu().numpy(), kf)
    assert t.cpu().numpy().tobytes() == np.float32(want).tobytes()


def test_collective_steps_on_two_entries_equal_cpu_entries(cuda_device):
    from wavelet_tpu_torch.runtime import distributed
    from wavelet_tpu_torch.runtime import mesh as mesh_lib

    batch = _batch((8, 16, 16, 8), 18)
    cpu = mesh_lib.data_mesh(["cpu"] * 4)
    for make in (distributed.make_parity_compress_step,
                 lambda m: distributed.make_global_compress_step(m, 0.05)):
        for a, b in zip(make(_mesh2())(batch), make(cpu)(batch)):
            assert np.ascontiguousarray(a).tobytes() == \
                np.ascontiguousarray(b).tobytes()
    recon, thr, rmse = distributed.make_train_step(_mesh2(), 0.05)(batch)
    crecon, cthr, crmse = distributed.make_train_step(cpu, 0.05)(batch)
    assert recon.tobytes() == crecon.tobytes() and thr == cthr
    np.testing.assert_allclose(rmse, crmse, rtol=1e-6)


def test_dryrun_multichip_on_the_card(cuda_device):
    from wavelet_tpu_torch import entry

    before = dict(pyramid_cuda.launches)
    out = entry.dryrun_multichip(2)
    assert np.isfinite(out["rmse"])
    assert pyramid_cuda.launches["forward_hist"] > before["forward_hist"]


def _xz_members(dims, seeds, kept=0.4):
    """xz members of smooth-field payloads, with their payloads."""
    from wavelet_tpu_torch.core import rle
    from wavelet_tpu_torch.io import archive

    m = int(np.prod(dims))
    out = []
    for s in seeds:
        rng = np.random.default_rng(s)
        idx = np.sort(rng.choice(m, int(m * kept), replace=False))
        vals = np.cumsum(rng.standard_normal(len(idx))).astype(np.float32)
        payload = archive.serialize_payload(dims, rle.rle_encode_pairs(idx),
                                            vals)
        out.append((payload, archive.xz_compress(payload)))
    return out


def test_xzdec_matches_plain_and_stdlib(cuda_device):
    from wavelet_tpu_torch.core import rle
    from wavelet_tpu_torch.io import archive
    from wavelet_tpu_torch.kernels import xzdec_cuda
    from wavelet_tpu_torch.runtime import carddecode

    dims = (16, 16, 16)
    members = _xz_members(dims, range(5))
    blobs = [b for _, b in members]
    bad = bytearray(blobs[1])
    lay = archive.xz_single_block(blobs[1])
    bad[lay[0] + lay[1] + (-lay[1] % 4)] ^= 1       # the CRC64
    blobs[1] = bytes(bad)
    before = xzdec_cuda.launches["xzdec"]
    card = carddecode.CardDecode(cuda_device, dims, blobs)
    card.close()
    card.finish()
    assert xzdec_cuda.launches["xzdec"] == before + 1
    plain = carddecode.CardDecode(torch.device("cpu"), dims, blobs)
    plain.finish()
    assert list(card.status) == list(plain.status) == [
        0, xzdec_cuda.CHECK_ERROR, 0, 0, 0]
    rows = card.rows.cpu().numpy()
    assert rows.view(np.int32).tobytes() == \
        plain.rows.numpy().view(np.int32).tobytes()
    for j, (payload, _) in enumerate(members):
        if j == 1:
            assert not rows[j].any()
            continue
        _, total, runs, vals = archive.deserialize_payload(payload)
        want = rle.rle_decode(runs, vals, total).reshape(dims)
        assert rows[j].view(np.int32).tobytes() == \
            want.view(np.int32).tobytes()
