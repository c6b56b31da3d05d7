"""Sparse transfer (``transfer=sparse|auto``) in the port, against the JAX
package and against the port's own dense transfer, on the CPU.

Synthetic plotfiles (2 timesteps, 2 levels, 2 components, boxes of mixed
even and odd shapes holding a sharp front over a constant with small
noise, so a few percent of the coefficients are kept) go through ``wavelet_tpu`` with
``transfer=sparse`` and through ``wavelet_tpu_torch`` (``device=cpu``) with
``transfer=dense`` and ``transfer=sparse``: the three archives must be
byte-identical for files/bundle, q16, raw and ``scales`` 1/2/3, and
``-d transfer=sparse`` must regenerate byte-identical plotfiles for
box-mode and global-mode archives.  The engine's sparse steps are held to
the JAX engine's on the same batches, and the fallbacks and the transport
policy mirror ``tests/test_sparse_transfer.py``.
"""

import logging
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from conftest import tree_bytes  # noqa: E402

from wavelet_tpu.pipeline import Config as JConfig  # noqa: E402
from wavelet_tpu.pipeline import compress_run as j_compress  # noqa: E402
from wavelet_tpu.pipeline import decompress_run as j_decompress  # noqa: E402
from wavelet_tpu.runtime import batching as jbatching  # noqa: E402
from wavelet_tpu.runtime import engine as jengine  # noqa: E402
import wavelet_tpu_torch  # noqa: E402
from wavelet_tpu_torch import cli  # noqa: E402
from wavelet_tpu_torch.core import rle  # noqa: E402
from wavelet_tpu_torch.io import archive, plotfile  # noqa: E402
from wavelet_tpu_torch.runtime import batching, engine  # noqa: E402

COMPS = ["density", "temp"]
STEPS = dict(min_time="plt00010", max_time="plt00020")
VARIANTS = {
    "default": {},
    "bundle": {"archive": "bundle"},
    "q16": {"payload": "q16"},
    "raw": {"codec": "raw"},
    "scales2": {"scales": 2},
    "scales3": {"scales": 3},
}
GLOBAL = {"threshold_mode": "global", "keep_fraction": 0.02, "scales": 2}


def _field(shape, t, q, rng):
    x, y, z = np.meshgrid(*[np.arange(n) for n in shape], indexing="ij")
    f = (np.tanh((x + 0.25 * y - 5.0 - 2.0 * t) / 0.5) + 0.5 * q
         + 1e-5 * rng.standard_normal(shape))
    return ((1.0 + q) * f).astype(np.float32)


def _write_data(root: str) -> str:
    rng = np.random.default_rng(12)
    data = os.path.join(root, "data")
    l0 = [((0, 0, 0), (16, 16, 16)), ((16, 0, 0), (16, 16, 16))]
    l1 = [((0, 0, 0), (7, 5, 3)), ((8, 0, 0), (8, 4, 2)),
          ((16, 0, 0), (16, 8, 8)), ((0, 16, 0), (16, 16, 16))]
    for t, name in enumerate(["plt00010", "plt00020"]):
        boxes = [[np.stack([_field(d, t, q, rng) for q in range(2)])
                  for _, d in lev] for lev in (l0, l1)]
        plotfile.write_plotfile(
            os.path.join(data, name), boxes,
            [[loc for loc, _ in lev] for lev in (l0, l1)],
            [[d for _, d in lev] for lev in (l0, l1)],
            COMPS, 0.5 + t, [0.0, 0.0, 0.0], [1.0, 0.5, 0.5], (2, 2, 2),
            (32, 16, 16), [10 * (t + 1), 20 * (t + 1)])
    return data


def _compress(data, arch, **kw):
    return wavelet_tpu_torch.compress(
        data, arch, components=COMPS, min_level=0, max_level=1,
        keep=0.999, device="cpu", **STEPS, **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per variant: the JAX package's sparse archive and the port's dense
    and sparse archives, with the port's stats."""
    root = str(tmp_path_factory.mktemp("torch_sparse"))
    data = _write_data(root)
    out = {"data": data, "root": root}
    for name, kw in {**VARIANTS, "global": GLOBAL}.items():
        d = os.path.join(root, name)
        j_arch = d + "/jax_sparse/"
        if name != "global":
            j_compress(JConfig(data_dir=data, min_level=0, max_level=1,
                               components=list(COMPS), keep=0.999,
                               compressed_dir=j_arch, transfer="sparse",
                               **STEPS, **kw))
        stats = {tr: _compress(data, d + f"/{tr}/", transfer=tr, **kw)
                 for tr in ("dense", "sparse")}
        out[name] = (j_arch, d + "/dense/", d + "/sparse/", stats)
    return out


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_sparse_archives_byte_identical(runs, variant):
    j_arch, dense, sparse, stats = runs[variant]
    want = tree_bytes(dense)
    assert len(want) > 5
    assert tree_bytes(sparse) == want
    assert tree_bytes(j_arch) == want
    # pairs really crossed the link: fewer bytes than the dense fetch
    assert (0 < stats["sparse"]["device_to_host_bytes"]
            < stats["dense"]["device_to_host_bytes"])


@pytest.mark.parametrize("variant", ["default", "scales2", "bundle", "q16",
                                     "global"])
def test_sparse_decompress_byte_identical(runs, variant, tmp_path):
    """``-d transfer=sparse`` regenerates the dense run's plotfiles, for
    box-mode and global-mode archives, and ships fewer bytes."""
    _, dense_arch, _, _ = runs[variant]
    outs, h2d = {}, {}
    for tr in ("dense", "sparse"):
        out = str(tmp_path / tr) + os.sep
        st = wavelet_tpu_torch.decompress(dense_arch, out, device="cpu",
                                          transfer=tr)
        outs[tr], h2d[tr] = tree_bytes(out), st["host_to_device_bytes"]
    assert len(outs["dense"]) == 10 and outs["sparse"] == outs["dense"]
    assert 0 < h2d["sparse"] < h2d["dense"]
    j_decompress(JConfig(compressed_dir=dense_arch,
                         out_dir=str(tmp_path / "jax")))
    assert tree_bytes(tmp_path / "jax") == outs["dense"]


def test_global_archive_unchanged_by_transfer(runs):
    """Global mode's pass 2 fetches dense coefficients under either key,
    as in the JAX package."""
    _, dense, sparse, stats = runs["global"]
    assert tree_bytes(sparse) == tree_bytes(dense)
    assert (stats["sparse"]["device_to_host_bytes"]
            == stats["dense"]["device_to_host_bytes"])


def test_cli_transfer_sparse_both_modes(runs, tmp_path):
    arch = str(tmp_path / "arch") + os.sep
    assert cli.main([f"datadir={runs['data']}", "minfile=plt00010",
                     "maxfile=plt00020", "minlevel=0", "maxlevel=1",
                     "components=density temp", "keep=0.999",
                     "transfer=sparse", f"compresseddir={arch}",
                     "device=cpu", "-c"]) == 0
    assert tree_bytes(arch) == tree_bytes(runs["default"][1])
    out = str(tmp_path / "out") + os.sep
    assert cli.main([f"compresseddir={arch}", f"out={out}",
                     "transfer=sparse", "device=cpu", "-d"]) == 0
    j_decompress(JConfig(compressed_dir=arch, out_dir=str(tmp_path / "j")))
    assert tree_bytes(out) == tree_bytes(tmp_path / "j")


@pytest.mark.parametrize("mode", ["c", "d"])
def test_cli_transfer_key_like_jax(mode):
    from wavelet_tpu import cli as jcli

    base = (["datadir=x", "minfile=a", "maxfile=b", "minlevel=0",
             "maxlevel=0", "components=temp", "keep=0.9", "compresseddir=y"]
            if mode == "c" else ["compresseddir=y", "out=z"])
    for t in ("dense", "sparse", "auto"):
        argv = base + [f"transfer={t}", "device=cpu", f"-{mode}"]
        assert cli.parse_argv(argv)[1].transfer == t
        assert jcli.parse_argv(argv[:-2] + [f"-{mode}"])[1].transfer == t
    argv = base + ["transfer=sparce", f"-{mode}"]
    with pytest.raises(SystemExit) as want:
        jcli.parse_argv(argv)
    with pytest.raises(SystemExit) as got:
        cli.parse_argv(argv)
    assert str(got.value) == str(want.value) and "sparce" in str(got.value)


# --------------------------------------------------- the engine, against JAX

def _batches(arrs, eng, mod=batching):
    items = [mod.WorkItem(t=0, level=0, comp_idx=0, box=b)
             for b in range(len(arrs))]
    return mod.plan_batches([(it, arrs[i]) for i, it in enumerate(items)],
                            pack_fn=eng.pack_factor)[0]


def _spiky(n, dims, seed, frac=0.01):
    rng = np.random.default_rng(seed)
    out = (rng.standard_normal((n,) + dims) * 1e-3).astype(np.float32)
    out[rng.random((n,) + dims) < frac] = 50.0
    out[:, 0, 0, 0] = 100.0
    return out


@pytest.mark.parametrize("dims,scales", [((16, 16, 16), 1),
                                         ((16, 16, 16), 2),
                                         ((9, 6, 5), 1), ((8, 8, 16), 3)])
def test_compress_shapebatch_sparse_matches_jax(dims, scales):
    """Counts, thresholds, the trimmed cap and every pair the packer reads
    equal the JAX engine's, over two batches (the cold 25% cap, then the
    adapted one)."""
    arrs = _spiky(6, dims, seed=sum(dims) + scales)
    eng = engine.CodecEngine(device="cpu", scales=scales)
    jeng = jengine.CodecEngine(scales=scales, use_pallas=False)
    for _ in range(2):
        s, t32 = eng.compress_shapebatch_sparse(_batches(arrs, eng), 0.999)
        js, jt32 = jeng.compress_shapebatch_sparse(
            _batches(arrs, jeng, jbatching), 0.999)
        np.testing.assert_array_equal(t32.view(np.int32),
                                      jt32.view(np.int32))
        np.testing.assert_array_equal(s.counts, js.counts)
        assert s.cap == js.cap and s.transfer_bytes() == js.transfer_bytes()
        for i in range(len(arrs)):
            a, b = s.item_pairs(i, float(t32[i])), js.item_pairs(
                i, float(jt32[i]))
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1].view(np.int32),
                                          b[1].view(np.int32))


@pytest.mark.parametrize("dims,scales", [((16, 16, 16), 1),
                                         ((16, 16, 16), 2),
                                         ((7, 5, 3), 1)])
def test_decompress_shapebatch_sparse_matches_jax_and_dense(dims, scales,
                                                           tmp_path):
    """Pairs from the packer -> scatter -> inverse: bitwise the JAX
    engine's sparse decompress and the port's dense decompress."""
    arrs = _spiky(5, dims, seed=7 + scales)
    eng = engine.CodecEngine(device="cpu", scales=scales)
    packer = engine.HostPacker()
    cb, t32 = eng.compress_shapebatch(_batches(arrs, eng), 0.999)
    packer.pack(str(tmp_path), cb, t32)
    shell = batching.ShapeBatch(shape=dims, data=None, items=cb.items,
                                n_valid=len(cb.items))
    idx, vals = packer.unpack_sparse(str(tmp_path), shell)
    assert (idx >= np.prod(dims)).any()          # padding slots present
    got = eng.decompress_shapebatch_sparse(shell, idx, vals).data
    want = jengine.CodecEngine(scales=scales, use_pallas=False)\
        .decompress_shapebatch_sparse(shell, idx, vals).data
    dense = batching.empty_batch(cb.items, dims, scales=eng.eff_scales(dims))
    packer.unpack_into(str(tmp_path), dense)
    dense = eng.decompress_shapebatch(dense).data
    np.testing.assert_array_equal(got.view(np.int32),
                                  np.asarray(want).view(np.int32))
    np.testing.assert_array_equal(got.view(np.int32),
                                  dense[: len(arrs)].view(np.int32))


# ------------------------------------------------ fallbacks (JAX's own cases)

def test_sparse_engine_overflow_fallback():
    rng = np.random.default_rng(1)
    arrs = rng.standard_normal((3, 4, 8, 16)).astype(np.float32)
    eng = engine.CodecEngine(device="cpu")
    # keep=2.0 negates the thresholds: a positive signed absmax keeps
    # everything, and every item overflows the 5% cap
    sparse, t32 = eng.compress_shapebatch_sparse(_batches(arrs, eng),
                                                 keep=2.0, cap_fraction=0.05)
    for i in range(3):
        idx, vals = sparse.item_pairs(i, float(t32[i]))
        row = sparse._flat_dev[i].numpy()
        want = np.flatnonzero(np.abs(row) > t32[i])
        np.testing.assert_array_equal(idx, want)
        np.testing.assert_array_equal(vals, row[want])
    assert (sparse.counts > sparse.cap).any()


def _boxes_case(n, spec, rng):
    out = np.zeros((n, 8, 8, 8), np.float32)
    for i in range(n):
        if spec(i) == "all":        # negative absmax -> keep all
            out[i] = -5.0
        elif spec(i) == "spiky":
            out[i] = rng.standard_normal((8, 8, 8)) * 1e-3
            out[i, 0, 0, 0] = 100.0
            out[i, 4, 4, 4] = 50.0
    return out


@pytest.mark.parametrize("name,n,spec,how", [
    ("single box all kept", 1, lambda i: "all", "dense alone"),
    ("two boxes all kept", 2, lambda i: "all", "dense alone"),
    ("one overflower among 15 sparse", 15,
     lambda i: "all" if i == 0 else "spiky", "per item"),
    ("widespread overflow", 12, lambda i: "all" if i % 2 else "spiky",
     "dense alone"),
    ("all sparse", 8, lambda i: "spiky", "pairs"),
])
def test_sparse_transfer_never_ships_more_than_dense(name, n, spec, how):
    """Every regime costs at most dense + the counts vector, by the honest
    accounting (pair buffers AND every fallback fetch item_pairs makes),
    and takes the fallback the JAX engine takes."""
    rng = np.random.default_rng(11)
    arrs = _boxes_case(n, spec, rng)
    eng = engine.CodecEngine(device="cpu")    # fresh adaptive hints
    batch = _batches(arrs, eng)
    dense_bytes = batch.data.nbytes
    s, t32 = eng.compress_shapebatch_sparse(batch, 0.999)
    for i in range(n):
        s.item_pairs(i, float(t32[i]))
        idx, vals = s.item_pairs(i, float(t32[i]))
        row = batch.data[i]
        np.testing.assert_array_equal(vals, s._flat_dev[i].numpy()[idx])
        assert len(idx) == int(s.counts[i]) and row.size == 512
    assert s.transfer_bytes() <= dense_bytes + s.counts.nbytes, name
    if how == "dense alone":
        assert s.cap == 0 and s._flat_np is not None
    elif how == "per item":
        assert s.cap > 0 and s._flat_np is None
        assert (s.counts > s.cap).sum() == 1
    else:
        assert s.cap > 0 and not (s.counts > s.cap).any()


@pytest.mark.parametrize("n_over,bulk", [(2, False), (4, False), (5, True)])
def test_overflow_fetch_is_per_item_or_one_bulk_fetch(n_over, bulk):
    """More than max(2, n/10) overflowing items: item_pairs fetches the
    whole flat array once, and transfer_bytes counts it; fewer: one row
    each.  (The engine ships such a batch dense alone, see above; this is
    SparseCoeffs' own rule.)"""
    n, m, cap = 40, 64, 8
    rng = np.random.default_rng(n_over)
    flat = torch.from_numpy(rng.standard_normal((n, m)).astype(np.float32))
    t32 = np.full(n, 3.0, np.float32)
    counts = (flat.abs() > 3.0).sum(dim=1, dtype=torch.int32).numpy()
    counts[:n_over] = m                 # pretend: past the cap
    flat[:n_over] = 9.0
    s = engine.SparseCoeffs(shape=(4, 4, 4), items=list(range(n)),
                            counts=counts,
                            idxs=np.zeros((n, cap), np.int32),
                            vals=np.zeros((n, cap), np.float32), cap=cap,
                            _flat_dev=flat)
    pairs = s.counts.nbytes + s.idxs.nbytes + s.vals.nbytes
    assert s.transfer_bytes() == pairs + (n * m * 4 if bulk
                                          else n_over * m * 4)
    idx, vals = s.item_pairs(0, float(t32[0]))
    np.testing.assert_array_equal(idx, np.arange(m))
    assert (vals == 9.0).all()
    assert (s._flat_np is not None) == bulk


def test_adaptive_sparse_cap_shrinks_transfer():
    """The pair buffers are trimmed to the observed max kept count (power
    of two) — even a shape's FIRST batch, whose compaction capacity is
    the cold 25% default; the next batch adapts its capacity."""
    eng = engine.CodecEngine(device="cpu")
    smooth = np.fromfunction(
        lambda n, i, j, k: np.sin(0.02 * i) + 0.01 * j + 0.005 * k + 0 * n,
        (8, 16, 16, 16)).astype(np.float32)
    s1, _ = eng.compress_shapebatch_sparse(_batches(smooth, eng), 0.9)
    hint = eng._sparse_cap_hint[(16, 16, 16)]
    assert hint < 0.25
    s2, _ = eng.compress_shapebatch_sparse(_batches(smooth, eng), 0.9)
    max_kept = int(s1.counts.max())
    assert s1.cap <= max(128, 2 * max_kept)
    assert s2.cap <= s1.cap
    for i in range(8):
        i1, v1 = s1.item_pairs(i, 0.0)
        i2, v2 = s2.item_pairs(i, 0.0)
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_array_equal(v1, v2)


def test_sparse_decompress_dense_fallback_when_pairs_exceed_dense(tmp_path):
    """Constant-negative data keeps every coefficient: the padded pair
    stream would cost more than the dense rows, so ``-d transfer=sparse``
    ships dense bytes and still regenerates identical plotfiles."""
    box = np.full((1, 8, 8, 8), -5.0, np.float32)
    plotfile.write_plotfile(str(tmp_path / "data" / "plt00070"),
                            [[box]], [[(0, 0, 0)]], [[(8, 8, 8)]], ["a"],
                            0.5, [0., 0., 0.], [1., 1., 1.], (2, 2, 2),
                            (8, 8, 8), [70])
    comp = str(tmp_path / "comp") + "/"
    wavelet_tpu_torch.compress(str(tmp_path / "data"), comp,
                               min_time="plt00070", max_time="plt00070",
                               components=["a"], device="cpu")
    stats = {}
    for mode in ("dense", "sparse"):
        stats[mode] = wavelet_tpu_torch.decompress(
            comp, str(tmp_path / f"out_{mode}"), device="cpu",
            transfer=mode)
    assert (stats["sparse"]["host_to_device_bytes"]
            == stats["dense"]["host_to_device_bytes"] > 0)
    assert tree_bytes(tmp_path / "out_sparse") == tree_bytes(
        tmp_path / "out_dense")


def _one_member(tmp_path, payload: bytes):
    comp = tmp_path / "comp"
    comp.mkdir()
    with open(comp / archive.payload_filename(0, 0, 0, 0), "wb") as f:
        f.write(archive.encode_blob(payload, "xz", 6))
    items = [batching.WorkItem(t=0, level=0, comp_idx=0, box=0)]
    return str(comp), items


def test_sparse_decompress_malformed_payload_matches_dense(tmp_path):
    """On corrupt RLE streams the sparse path reconstructs exactly what
    the dense path does (the reference's skip-increment semantics)."""
    dims, total = (4, 4, 4), 64
    runs = np.array([2, 100, -50, 1], np.int32)
    vals = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    comp, items = _one_member(tmp_path,
                              archive.serialize_payload(dims, runs, vals))
    packer = engine.HostPacker()
    dense = batching.empty_batch(items, dims, pack=1)
    packer.unpack_into(comp, dense)
    idx, svals = packer.unpack_sparse(
        comp, batching.ShapeBatch(shape=dims, data=None, items=items,
                                  n_valid=1))
    scattered = np.zeros(total, np.float32)
    keep = idx[0] < total
    scattered[idx[0][keep]] = svals[0][keep]
    assert np.array_equal(scattered,
                          np.asarray(dense.item_view(0)).reshape(-1))
    pos, _ = rle.rle_decode_pairs(runs, vals, total)
    assert idx.shape == (1, 64) and keep.sum() == len(pos)


def test_sparse_decompress_rejects_total_mismatch(tmp_path):
    dims = (4, 4, 4)
    payload = bytearray(archive.serialize_payload(
        dims, np.array([0], np.int32), np.array([1.0], np.float32)))
    payload[12:16] = np.int32(128).tobytes()     # forge the total field
    comp, items = _one_member(tmp_path, bytes(payload))
    with pytest.raises(ValueError, match="total"):
        engine.HostPacker().unpack_sparse(
            comp, batching.ShapeBatch(shape=dims, data=None, items=items,
                                      n_valid=1))


# ------------------------------------------------------- the transport policy

@pytest.fixture
def breakevens(monkeypatch):
    monkeypatch.setattr(engine.CodecEngine, "_AUTO_SPARSE_BELOW_GBPS",
                        {"d2h": 100.0, "h2d": 200.0})


def test_auto_on_cpu_is_dense_without_a_link(monkeypatch, breakevens):
    def boom(cls):
        raise AssertionError("probed a link on device=cpu")

    monkeypatch.setattr(engine.CodecEngine, "_measure_link",
                        classmethod(boom))
    monkeypatch.setattr(engine.CodecEngine, "_measured_link_gbps", None)
    e = engine.CodecEngine(device="cpu")
    assert e.transfer_mode((16, 16, 16), "auto") == "dense"
    assert e.transfer_mode((16, 16, 16), "auto", direction="h2d") == "dense"
    assert e.transfer_mode((16, 16, 16), "sparse") == "sparse"
    assert e.transfer_mode((16, 16, 16), "dense") == "dense"


def test_transfer_auto_picks_by_link_and_bytes_match(runs, tmp_path,
                                                     monkeypatch,
                                                     breakevens):
    """``auto`` resolves per direction against the injected link, and
    either resolution gives the explicit transfer's archive."""
    e = engine.CodecEngine(device="cpu")
    monkeypatch.setattr(engine.CodecEngine, "_measured_link_at", 0.0)
    monkeypatch.setattr(engine.CodecEngine, "_measured_link_gbps",
                        {"d2h": 0.05, "h2d": 0.05})
    assert e.transfer_mode((16, 16, 16), "auto") == "sparse"
    slow = _compress(runs["data"], str(tmp_path / "slow") + "/",
                     transfer="auto")
    monkeypatch.setattr(engine.CodecEngine, "_measured_link_gbps",
                        {"d2h": 150.0, "h2d": 150.0})
    assert e.transfer_mode((16, 16, 16), "auto") == "dense"
    assert e.transfer_mode((16, 16, 16), "auto", direction="h2d") == \
        "sparse"
    fast = _compress(runs["data"], str(tmp_path / "fast") + "/",
                     transfer="auto")
    dense_stats = runs["default"][3]
    assert slow["device_to_host_bytes"] == \
        dense_stats["sparse"]["device_to_host_bytes"]
    assert fast["device_to_host_bytes"] == \
        dense_stats["dense"]["device_to_host_bytes"]
    want = tree_bytes(runs["default"][1])
    assert tree_bytes(tmp_path / "slow") == want == tree_bytes(
        tmp_path / "fast")


def test_auto_reprobes_on_cadence(monkeypatch, caplog, breakevens):
    """After the cadence expires, the timestep-boundary refresh sees the
    drifted link and flips the transport; ``transfer_mode`` itself never
    re-probes (it runs mid-pipeline, where the link is busy)."""
    rates = iter([{"d2h": 400.0, "h2d": 400.0, "probe_bytes": 8 << 20},
                  {"d2h": 0.05, "h2d": 0.05, "probe_bytes": 8 << 20}])
    monkeypatch.setattr(engine.CodecEngine, "_measure_link",
                        classmethod(lambda cls: next(rates)))
    monkeypatch.setattr(engine.CodecEngine, "_measured_link_gbps", None)
    monkeypatch.setattr(engine.CodecEngine, "_measured_link_at", 0.0)
    monkeypatch.setattr(engine.CodecEngine, "_LINK_REPROBE_S", 60.0)
    e = engine.CodecEngine(device="cpu")
    # a CPU engine measures no link: the CUDA engine's first call does
    assert e.transfer_mode((16, 16, 16), "auto") == "dense"
    assert engine.CodecEngine._link_gbps()["d2h"] == 400.0
    assert engine.CodecEngine._measured_link_at > 0
    monkeypatch.setattr(e, "device", torch.device("cuda", 0))
    assert e.transfer_mode((16, 16, 16), "auto") == "dense"   # fast link
    engine.CodecEngine.reprobe_link_if_stale()      # within the cadence
    assert e.transfer_mode((16, 16, 16), "auto") == "dense"
    monkeypatch.setattr(engine.CodecEngine, "_measured_link_at",
                        time.monotonic() - 61.0)
    assert e.transfer_mode((16, 16, 16), "auto") == "dense"
    with caplog.at_level(logging.INFO, logger="wavelet_tpu_torch"):
        engine.CodecEngine.reprobe_link_if_stale()
        assert e.transfer_mode((16, 16, 16), "auto") == "sparse"
    assert any("drifted" in r.message for r in caplog.records)


def test_injected_link_values_never_reprobed(monkeypatch, breakevens):
    def boom(cls):
        raise AssertionError("re-probed over an injected value")

    monkeypatch.setattr(engine.CodecEngine, "_measure_link",
                        classmethod(boom))
    monkeypatch.setattr(engine.CodecEngine, "_measured_link_gbps",
                        {"d2h": 400.0, "h2d": 400.0})
    monkeypatch.setattr(engine.CodecEngine, "_measured_link_at", 0.0)
    e = engine.CodecEngine(device="cpu")
    assert e.transfer_mode((16, 16, 16), "auto") == "dense"
    engine.CodecEngine.reprobe_link_if_stale()
    assert e.transfer_mode((16, 16, 16), "auto") == "dense"


def test_breakevens_are_set():
    b = engine.CodecEngine._AUTO_SPARSE_BELOW_GBPS
    assert set(b) == {"d2h", "h2d"} and min(b.values()) > 0
